// Fused Q8_0 dequant-matmul: y (B, N) bf16 = x (B, K) bf16 . W^T, with W
// (N, K) held as its raw GGUF Q8_0 blocks (34 bytes per 32 weights: f16 d
// then 32 int8), one row of K/32 blocks per output feature.  f32
// accumulation, bf16 out.
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/q8matmul.py::
// _q8_matmul_kernel (q8_matmul / q8_matmul_stacked).  The Pallas kernel
// took a host repack (element-major int8 columns, block scales folded to
// bf16 and duplicated over 128 lanes); this one reads the file's blocks and
// multiplies by the exact f16 d in f32, so loading a weight is an upload.
//
// Bound on the H100: bytes at decode (B = 1: 8.5 bits/weight read once,
// 2 flops/weight), operations at prefill (B = 256).  Two paths
// (qmma_route.cu):
//   - B >= the route's threshold and K a multiple of 256 (every prompt pass
//     at the 8B shapes): the tensor-core template of qmma.cuh with the
//     Q8_0 decoder below, which treats eight blocks (272 bytes, 256
//     weights) as the template's super-block and turns each block into
//     bf16 — d*q exact in f32, rounded once, so the product is the bf16
//     plane's;
//   - otherwise (decode; any K that is a multiple of 32 only): the
//     CUDA-core kernel, the same design as q4k_matmul.cu: one warp per
//     output row, WARPS rows per block, RB activation rows per block staged
//     in padded shared memory as f32.  The warp walks K in chunks of 256 (8
//     Q8_0 blocks); lane l owns block l/4 of the chunk, elements
//     (l%4)*8..+8.  K needs only be a multiple of 32, so the last chunk may
//     be partial: its staged columns past K are zero and its lanes past the
//     last block skip.
//
// Alignment: a 34-byte block is only 2-byte aligned, so a lane's 8 payload
// bytes (at 34*b + 2 + e0) are read as four 16-bit words, and the f16 d as
// one; a 4- or 8-byte load there would fault with a misaligned address.
#include "qmma.cuh"

namespace {

constexpr int CHUNK = 256;                      // elements per step (8 blocks)
constexpr int XPAD = CHUNK + CHUNK / 8;

__device__ __forceinline__ int xslot(int c) { return c + (c >> 3); }

// Weights 32c..32c+31 — Q8_0 block c of a group of eight, at byte 34c of
// the 272-byte group (16-byte aligned in shared memory) — as 16 bf16
// pairs.  The payload is 2-byte aligned: read as words with funnel shifts
// (for c = 7 the last aligned word lies past the group, in the next slot
// or the allocation's alignment slack, and is not used).  q from each byte
// exactly: b ^ 0x80 is q + 128, as 2^23 + q + 128 through byte_f; then
// w = d*q, exact in f32 (11 + 8 bits) as the codec computes it, rounded
// once to bf16.  The 272-byte slot leaves room for two x stages, not three
// (qmma.cuh xstages).
struct Q8Decoder {
    static constexpr int BLOCK = 8 * lfkt::Q8_0_BLOCK;   // 272: seventeen 16-byte chunks
    static constexpr int SLOT = BLOCK;
    static __device__ __forceinline__ void decode32(const uint8_t* grp, int c,
                                                    uint32_t (&out)[16]) {
        const uint8_t* blk = grp + c * lfkt::Q8_0_BLOCK;
        const float d = lfkt::f16_at(blk);
        uint32_t qs[8];
        lfkt::qmma::load32_a2(blk + 2, qs);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const uint32_t u = qs[i] ^ 0x80808080u;
            float f[4];
#pragma unroll
            for (int b = 0; b < 4; ++b)   // 2^23 + q + 128, less 2^23 + 128
                f[b] = __fmul_rn(d, __fsub_rn(lfkt::qmma::byte_f(u, b), 8388736.0f));
            out[2 * i] = lfkt::qmma::pack_bf16(f[0], f[1]);
            out[2 * i + 1] = lfkt::qmma::pack_bf16(f[2], f[3]);
        }
    }
};

__device__ __forceinline__ float i8(uint32_t word, int k) {
    return static_cast<float>(static_cast<int8_t>((word >> (8 * k)) & 0xFF));
}

template <int WARPS, int RB>
__global__ void __launch_bounds__(WARPS * 32)
q8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ w,
                 __nv_bfloat16* __restrict__ y, int B, int N, int K) {
    __shared__ float xs[RB][XPAD];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int n = blockIdx.x * WARPS + warp;
    const int b0 = blockIdx.y * RB;
    const int nblk = K / lfkt::QK8_0;
    const int bl = lane >> 2;             // block 0..7 within the chunk
    const int e0 = (lane & 3) * 8;        // first element within it
    const uint8_t* wrow = w + static_cast<size_t>(n < N ? n : 0) * nblk * lfkt::Q8_0_BLOCK;

    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;

    for (int k0 = 0; k0 < K; k0 += CHUNK) {
        __syncthreads();
        for (int i = threadIdx.x; i < RB * CHUNK; i += WARPS * 32) {
            const int r = i / CHUNK, c = i % CHUNK;
            const int b = b0 + r;
            xs[r][xslot(c)] = (b < B && k0 + c < K)
                ? __bfloat162float(x[static_cast<size_t>(b) * K + k0 + c])
                : 0.f;
        }
        __syncthreads();
        const int gb = k0 / lfkt::QK8_0 + bl;
        if (n >= N || gb >= nblk) continue;
        const uint8_t* blk = wrow + static_cast<size_t>(gb) * lfkt::Q8_0_BLOCK;
        const float d = lfkt::f16_at(blk);
        uint32_t lo, hi;
        lfkt::load8_a2(blk + 2 + e0, lo, hi);
        float q[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            q[k] = i8(lo, k);
            q[k + 4] = i8(hi, k);
        }
        const int c0 = bl * lfkt::QK8_0 + e0;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            float sqx = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) sqx = fmaf(q[k], xs[r][xslot(c0 + k)], sqx);
            acc[r] = fmaf(d, sqx, acc[r]);
        }
    }
    if (n >= N) return;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
        const float v = lfkt::warp_sum(acc[r]);
        if (lane == 0 && b0 + r < B) y[static_cast<size_t>(b0 + r) * N + n] = __float2bfloat16_rn(v);
    }
}

template <int WARPS, int RB>
int launch(const void* x, const void* w, void* y, int B, int N, int K, cudaStream_t s) {
    dim3 grid((N + WARPS - 1) / WARPS, (B + RB - 1) / RB);
    q8_matmul_kernel<WARPS, RB><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
        static_cast<__nv_bfloat16*>(y), B, N, K);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFKT_API int lfkt_q8_matmul(const void* x, const void* w, void* y, int B, int N,
                            int K, void* stream) {
    if (B <= 0 || N <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (lfkt::qmma::use_tc(lfkt::qmma::FMT_Q8_0, B, K))
        return lfkt::qmma::launch<Q8Decoder>(x, w, y, B, N, K, s);
    if (B == 1) return launch<8, 1>(x, w, y, B, N, K, s);
    return launch<16, 8>(x, w, y, B, N, K, s);
}
