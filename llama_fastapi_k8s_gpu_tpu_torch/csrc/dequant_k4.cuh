// The whole-tensor Q4_K / Q5_K -> bf16 or f32 dequant kernel, one template
// for both formats (dequant_q4k.cu and dequant_q5k.cu each launch it; their
// header comments carry the bound and the measurements).
//
// A warp decodes one super-block, and every one of its stores writes one
// contiguous 512-byte run of the output: lane l writes 16-byte run
// l + 32k of the super-block's 256 outputs (k = 0 in bf16, where a run is
// 8 elements; k = 0, 1 in f32, where it is 4).  A run lies inside one
// 32-element sub-block j, so the lane decodes one scale and min for it
// (lfkt::scale_min_k4 on the header's words) and reads its nibbles from
// one 8- (bf16) or 4-byte (f32) load: the low nibbles of nibble bytes
// (j/2)*32 + i for even j, the high ones for odd j.  The two lanes whose
// runs share those bytes (sub-blocks 2g and 2g + 1) load them in the same
// instruction, so each payload byte crosses from memory once, as the TPU
// kernel reads it once.  Q5_K adds the run's qh bytes i.. (one more load)
// and bit j of each.  The 16-byte header (d, dmin, the 12 packed scale
// bytes) is one 16-byte load a lane, one address a warp.  Blocks of 144
// and 176 bytes keep every header and run aligned to its load's width
// when the tensor's base is 16-byte aligned, which the wrapper requires.
//
// Why these runs (chip_smoke.py's dequant_shapes: device time from a CUDA
// graph over the byte bound at the loads' five shapes; NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md §6): a lane per 8-byte nibble run (16
// outputs, 16 lanes a super-block, each store instruction of a warp
// writing 64-byte pieces) took 1.28-2.83x; a lane per 16-byte run,
// 2.2-3.3x; runs of 8 in f32 too (each of a lane's two float4 stores
// writing half of every 32-byte sector) took 1.21-1.94x in f32, worst at
// 1024 x 4096; the 4-element f32 runs above, 1.16-1.33x.
#pragma once

#include "common.cuh"

namespace lfkt {
namespace dequant_k4 {

constexpr int THREADS = 256;
constexpr int LANES = 32;          // lanes a super-block: one warp
constexpr int LANE_SHIFT = 5;      // log2(LANES)

// 4 or 8 bytes at an address aligned to their width, as one load
template <int W>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&w)[W]) {
    if constexpr (W == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        w[0] = v.x;
        w[1] = v.y;
    } else {
        w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
}

// y = (d * sc) * q - dmin * mn with the codec's roundings (gguf/quants.py):
// d * sc and dmin * mn each rounded in f32, then one FMA, which rounds as
// the codec's multiply and subtract do because (d * sc) * q is exact
// (11 + 6 + 4 bits for Q4_K, 11 + 6 + 5 for Q5_K: at most 22 of f32's 24);
// bf16 out by round-to-nearest-even.
template <bool Q5, typename T>
__global__ void __launch_bounds__(THREADS)
kernel(const uint8_t* __restrict__ raw, T* __restrict__ out, long long n_blocks) {
    constexpr int BLOCK = Q5 ? Q5K_BLOCK : Q4K_BLOCK;
    constexpr int QS = Q5 ? 48 : 16;                 // offset of the nibble bytes
    constexpr int E = 16 / sizeof(T);                // elements of a 16-byte run
    constexpr int RUNS = QK_K / (LANES * E);         // runs a lane: 1 (bf16), 2 (f32)
    const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    const long long blk = t >> LANE_SHIFT;
    if (blk >= n_blocks) return;
    const int l = static_cast<int>(t) & (LANES - 1);
    const uint8_t* b = raw + blk * BLOCK;
    const uint4 h = *reinterpret_cast<const uint4*>(b);
    const float d = __half2float(__ushort_as_half(static_cast<unsigned short>(h.x & 0xFFFFu)));
    const float dmin = __half2float(__ushort_as_half(static_cast<unsigned short>(h.x >> 16)));
#pragma unroll
    for (int k = 0; k < RUNS; ++k) {
        const int e0 = E * (l + LANES * k);          // the run's first element
        const int j = e0 >> 5, i = e0 & 31;          // its sub-block, and index there
        // q bytes of elements i..i+E-1, four to a word
        uint32_t q[E / 4];
        load_words(b + QS + (j >> 1) * 32 + i, q);
#pragma unroll
        for (int w = 0; w < E / 4; ++w) q[w] = (q[w] >> (4 * (j & 1))) & 0x0F0F0F0Fu;
        if constexpr (Q5) {
            // + 16 * bit j of qh[i] for element i of sub-block j
            uint32_t qh[E / 4];
            load_words(b + 16 + i, qh);
#pragma unroll
            for (int w = 0; w < E / 4; ++w) q[w] |= ((qh[w] >> j) & 0x01010101u) << 4;
        }
        int sc, mn;
        scale_min_k4(h.y, h.z, h.w, j, sc, mn);
        const float scale = __fmul_rn(d, static_cast<float>(sc));
        const float minv = __fmul_rn(dmin, static_cast<float>(mn));
        float y[E];
#pragma unroll
        for (int e = 0; e < E; ++e)
            y[e] = __fmaf_rn(scale, static_cast<float>((q[e >> 2] >> (8 * (e & 3))) & 0xFFu),
                             -minv);
        if constexpr (E == 8)
            store8(out + blk * QK_K + e0, y);
        else
            *reinterpret_cast<float4*>(out + blk * QK_K + e0) = make_float4(y[0], y[1], y[2], y[3]);
    }
}

template <bool Q5>
int launch(const void* raw, void* out, long long n_blocks, int out_f32, cudaStream_t stream) {
    if (n_blocks <= 0) return 0;
    const dim3 grid(static_cast<unsigned>((n_blocks * LANES + THREADS - 1) / THREADS));
    const auto* in = static_cast<const uint8_t*>(raw);
    if (out_f32)
        kernel<Q5, float><<<grid, THREADS, 0, stream>>>(in, static_cast<float*>(out), n_blocks);
    else
        kernel<Q5, __nv_bfloat16><<<grid, THREADS, 0, stream>>>(
            in, static_cast<__nv_bfloat16*>(out), n_blocks);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace dequant_k4
}  // namespace lfkt
