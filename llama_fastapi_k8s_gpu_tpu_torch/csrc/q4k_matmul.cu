// Fused Q4_K dequant-matmul: y (B, N) bf16 = x (B, K) bf16 . W^T, with W
// (N, K) held as its raw GGUF Q4_K blocks, one row of K/256 blocks per
// output feature.  f32 accumulation, bf16 out.
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/qmatmul.py::
// _q4k_matmul_kernel (q4k_matmul / q4k_matmul_stacked).  That kernel needed
// a TPU-specific repack (re-biased nibble planes, element-major columns,
// bf16-folded scales and 128 correction columns dotted on the MXU).  This
// one decodes the file's own bytes in registers, as llama.cpp's CUDA matvec
// kernels do, so loading a weight is an upload with no repack.  Its scales
// stay exact f32 (d*sc, dmin*mn), where the Pallas kernel rounded them to
// bf16; the two therefore agree to bf16-rounding scale, not bit for bit.
//
// Bound on the H100: bytes at decode (B = 1: every weight byte is read
// once, ~4.5 bits/weight, 2 flops/weight), operations at prefill (B = 256:
// 512 flops/weight, ~900 per weight byte).  Two paths, chosen by B alone
// (qmma_route.cu):
//   - B >= the route's threshold (every prompt pass): the tensor-core
//     template of qmma.cuh with the Q4_K decoder below, which turns 32
//     weights of a staged block into bf16 — each the f32 codec's value
//     rounded once, so the product is the bf16 plane's;
//   - below it (decode): the CUDA-core kernel:
//   - a block of WARPS warps owns WARPS consecutive output rows, one warp
//     per row; grid.y tiles the activation rows by RB;
//   - the warp walks the row's super-blocks; lane l decodes the 8 weights
//     (sub-block l/4, elements (l%4)*8..+8) from one 8-byte load plus the
//     shared 16-byte header, and reuses them for all RB activation rows;
//   - the RB x 256 activation slice of the current super-block is staged
//     once per block in shared memory as f32, padded one float every 8 so
//     the lanes' 8-float reads hit distinct banks;
//   - per activation row the lane keeps sum(q*x) and sum(x); the sub-block
//     scale and min apply once per 8 weights: acc += d*sc*sum(qx) -
//     dmin*mn*sum(x); a warp reduction finishes the row.
#include "qmma.cuh"

namespace {

constexpr int XPAD = lfkt::QK_K + lfkt::QK_K / 8;   // 288 floats per staged row

__device__ __forceinline__ int xslot(int c) { return c + (c >> 3); }

// Weights 32c..32c+31 (sub-block j = c) of the Q4_K block at `blk` (16-byte
// aligned in shared memory) as 16 bf16 pairs: the nibbles of one 32-byte
// run (low for even j, high for odd j), w = d*sc*q - dmin*mn rounded in
// f32 as the codec rounds it (d*sc*q is exact: 11 + 6 + 4 bits, so one
// fused multiply-add rounds as its multiply and subtract do), then to bf16.
struct Q4KDecoder {
    static constexpr int BLOCK = lfkt::Q4K_BLOCK;
    static constexpr int SLOT = 144;         // nine 16-byte chunks: an odd count
    static __device__ __forceinline__ void decode32(const uint8_t* blk, int j,
                                                    uint32_t (&out)[16]) {
        const float d = lfkt::f16_at(blk);
        const float dmin = lfkt::f16_at(blk + 2);
        int sc, mn;
        lfkt::scale_min_k4(blk + 4, j, sc, mn);
        const float scale = d * static_cast<float>(sc);
        const float minv = dmin * static_cast<float>(mn);
        const uint4* qs4 = reinterpret_cast<const uint4*>(blk + 16 + (j >> 1) * 32);
        const uint4 s0 = qs4[0], s1 = qs4[1];
        const uint32_t qs[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const int nsh = (j & 1) * 4;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const uint32_t q = (qs[i] >> nsh) & 0x0F0F0F0Fu;
            float f[4];
#pragma unroll
            for (int b = 0; b < 4; ++b)
                f[b] = __fmaf_rn(scale, __fsub_rn(lfkt::qmma::byte_f(q, b), 8388608.0f), -minv);
            out[2 * i] = lfkt::qmma::pack_bf16(f[0], f[1]);
            out[2 * i + 1] = lfkt::qmma::pack_bf16(f[2], f[3]);
        }
    }
};

template <int WARPS, int RB>
__global__ void __launch_bounds__(WARPS * 32)
q4k_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ w,
                  __nv_bfloat16* __restrict__ y, int B, int N, int K) {
    __shared__ float xs[RB][XPAD];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int n = blockIdx.x * WARPS + warp;
    const int b0 = blockIdx.y * RB;
    const int nb = K / lfkt::QK_K;
    const int j = lane >> 2;              // sub-block 0..7
    const int e0 = (lane & 3) * 8;        // first element within it
    const int shift = (j & 1) * 4;
    const uint8_t* wrow = w + static_cast<size_t>(n < N ? n : 0) * nb * lfkt::Q4K_BLOCK;

    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;

    for (int sb = 0; sb < nb; ++sb) {
        __syncthreads();
        for (int i = threadIdx.x; i < RB * lfkt::QK_K; i += WARPS * 32) {
            const int r = i / lfkt::QK_K, c = i % lfkt::QK_K;
            const int b = b0 + r;
            xs[r][xslot(c)] = b < B
                ? __bfloat162float(x[static_cast<size_t>(b) * K + sb * lfkt::QK_K + c])
                : 0.f;
        }
        __syncthreads();
        if (n >= N) continue;
        const uint8_t* blk = wrow + static_cast<size_t>(sb) * lfkt::Q4K_BLOCK;
        const float d = lfkt::f16_at(blk);
        const float dmin = lfkt::f16_at(blk + 2);
        int sc, mn;
        lfkt::scale_min_k4(blk + 4, j, sc, mn);
        const uint2 raw = *reinterpret_cast<const uint2*>(blk + 16 + (j >> 1) * 32 + e0);
        float q[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            q[k] = static_cast<float>((raw.x >> (8 * k + shift)) & 0x0F);
            q[k + 4] = static_cast<float>((raw.y >> (8 * k + shift)) & 0x0F);
        }
        const float scale = d * static_cast<float>(sc);
        const float minv = dmin * static_cast<float>(mn);
        const int c0 = j * 32 + e0;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            float sqx = 0.f, sx = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const float xv = xs[r][xslot(c0 + k)];
                sqx = fmaf(q[k], xv, sqx);
                sx += xv;
            }
            acc[r] += scale * sqx - minv * sx;
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
    q4k_matmul_kernel<WARPS, RB><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
        static_cast<__nv_bfloat16*>(y), B, N, K);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFKT_API int lfkt_q4k_matmul(const void* x, const void* w, void* y, int B, int N,
                             int K, void* stream) {
    if (B <= 0 || N <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (lfkt::qmma::use_tc(lfkt::qmma::FMT_Q4K, B, K))
        return lfkt::qmma::launch<Q4KDecoder>(x, w, y, B, N, K, s);
    if (B == 1) return launch<8, 1>(x, w, y, B, N, K, s);
    return launch<16, 8>(x, w, y, B, N, K, s);
}
