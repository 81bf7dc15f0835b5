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
// 512 flops/weight, ~900 per weight byte).  First, simple design, CUDA
// cores only:
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
// The tensor cores are unused here (wgmma would need a dequantized tile in
// shared memory) — the obvious next step for the prefill shapes.
#include "common.cuh"

namespace {

constexpr int XPAD = lfkt::QK_K + lfkt::QK_K / 8;   // 288 floats per staged row

__device__ __forceinline__ int xslot(int c) { return c + (c >> 3); }

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
    if (B == 1) return launch<8, 1>(x, w, y, B, N, K, s);
    return launch<16, 8>(x, w, y, B, N, K, s);
}
