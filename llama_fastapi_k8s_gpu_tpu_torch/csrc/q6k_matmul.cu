// Fused Q6_K dequant-matmul: y (B, N) bf16 = x (B, K) bf16 . W^T, with W
// (N, K) held as its raw GGUF Q6_K blocks (210 bytes per 256 weights), one
// row of K/256 blocks per output feature.  f32 accumulation, bf16 out.
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/q6matmul.py::
// _q6k_matmul_kernel (q6k_matmul / q6k_matmul_stacked, default `cur`) and
// _q6k_pre_kernel (the `pre` layout of the same function).  The Pallas
// kernels took a host repack (nibble and crumb planes, element-major
// columns, bf16-folded d*sc and 256 correction columns).  Here the block
// bytes are decoded in registers: q6 = (ql nibble) | (qh crumb << 4),
// w = d * sc[16-element sub-block] * (q6 - 32), with d*sc exact in f32.
//
// Bound on the H100: bytes at decode (~6.6 bits/weight read once per
// token; the 128256 x 4096 output head alone is 431 MB), operations at
// prefill.  Two paths, chosen by B alone (qmma_route.cu): at and above the
// route's threshold (every prompt pass) the tensor-core template of
// qmma.cuh with the Q6_K decoder below; under it (decode) the CUDA-core
// kernel, the same design as q4k_matmul.cu: one warp per output row, WARPS
// rows per block, RB activation rows per block staged in padded shared
// memory; lane l owns elements l*8..l*8+7 of each super-block, which sit in
// one 16-element sub-block, one 8-byte run of ql and one of qh.  A 210-byte
// block is only 2-byte aligned when rows hold an odd number of blocks, so
// the ql/qh runs are read as four 16-bit words each.
#include "qmma.cuh"

namespace {

constexpr int XPAD = lfkt::QK_K + lfkt::QK_K / 8;

__device__ __forceinline__ int xslot(int c) { return c + (c >> 3); }

// Weights 32c..32c+31 of the Q6_K block at `blk` (2-byte aligned in shared
// memory: a 210-byte block sits at any even offset of its 16-byte span) as
// 16 bf16 pairs.  Chunk c is quarter q = c%4 of half h = c/4: its ql run
// (32 bytes, low nibbles for q < 2), its qh run (the half's 32 bytes, crumb
// q) and two 16-element scales; w = (d*sc)*(q6 - 32) rounded in f32 as the
// codec rounds it, then to bf16.
struct Q6KDecoder {
    static constexpr int BLOCK = lfkt::Q6K_BLOCK;
    static constexpr int SLOT = 240;         // 210 + up to 14 of offset, odd chunks
    static __device__ __forceinline__ void decode32(const uint8_t* blk, int c,
                                                    uint32_t (&out)[16]) {
        const int h = c >> 2, q = c & 3;
        uint32_t ql[8], qh[8];
        lfkt::qmma::load32_a2(blk + h * 64 + (q & 1) * 32, ql);
        lfkt::qmma::load32_a2(blk + 128 + h * 32, qh);
        const int lsh = (q >> 1) * 4, hsh = q * 2;
        const float d = lfkt::f16_at(blk + 208);
        const float s0 = d * static_cast<float>(static_cast<int8_t>(blk[192 + 2 * c]));
        const float s1 = d * static_cast<float>(static_cast<int8_t>(blk[193 + 2 * c]));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const uint32_t v = ((ql[i] >> lsh) & 0x0F0F0F0Fu) | (((qh[i] >> hsh) & 0x03030303u) << 4);
            const float sc = i < 4 ? s0 : s1;
            float f[4];
#pragma unroll
            for (int b = 0; b < 4; ++b)   // 2^23 + q6, less 2^23 + 32
                f[b] = __fmul_rn(sc, __fsub_rn(lfkt::qmma::byte_f(v, b), 8388640.0f));
            out[2 * i] = lfkt::qmma::pack_bf16(f[0], f[1]);
            out[2 * i + 1] = lfkt::qmma::pack_bf16(f[2], f[3]);
        }
    }
};

template <int WARPS, int RB>
__global__ void __launch_bounds__(WARPS * 32)
q6k_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ w,
                  __nv_bfloat16* __restrict__ y, int B, int N, int K) {
    __shared__ float xs[RB][XPAD];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int n = blockIdx.x * WARPS + warp;
    const int b0 = blockIdx.y * RB;
    const int nb = K / lfkt::QK_K;
    // element i = lane*8 + k: half h = i/128, r = i%128 within the half
    const int h = lane >> 4;
    const int r0 = (lane & 15) * 8;
    const int ql_off = h * 64 + (r0 & 63);
    const int ql_shift = (r0 >= 64) ? 4 : 0;
    const int qh_off = 128 + h * 32 + (r0 & 31);
    const int qh_shift = 2 * (r0 >> 5);
    const int sub = lane >> 1;           // 16-element sub-block 0..15
    const uint8_t* wrow = w + static_cast<size_t>(n < N ? n : 0) * nb * lfkt::Q6K_BLOCK;

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
        const uint8_t* blk = wrow + static_cast<size_t>(sb) * lfkt::Q6K_BLOCK;
        const float scale = lfkt::f16_at(blk + 208) *
                            static_cast<float>(static_cast<int8_t>(blk[192 + sub]));
        uint32_t l0, l1, h0, h1;
        lfkt::load8_a2(blk + ql_off, l0, l1);
        lfkt::load8_a2(blk + qh_off, h0, h1);
        float q[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int a0 = ((l0 >> (8 * k + ql_shift)) & 0x0F) |
                           (((h0 >> (8 * k + qh_shift)) & 3) << 4);
            const int a1 = ((l1 >> (8 * k + ql_shift)) & 0x0F) |
                           (((h1 >> (8 * k + qh_shift)) & 3) << 4);
            q[k] = static_cast<float>(a0 - 32);
            q[k + 4] = static_cast<float>(a1 - 32);
        }
        const int c0 = lane * 8;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            float sqx = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) sqx = fmaf(q[k], xs[r][xslot(c0 + k)], sqx);
            acc[r] = fmaf(scale, sqx, acc[r]);
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
    q6k_matmul_kernel<WARPS, RB><<<grid, WARPS * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
        static_cast<__nv_bfloat16*>(y), B, N, K);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFKT_API int lfkt_q6k_matmul(const void* x, const void* w, void* y, int B, int N,
                             int K, void* stream) {
    if (B <= 0 || N <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (lfkt::qmma::use_tc(lfkt::qmma::FMT_Q6K, B, K))
        return lfkt::qmma::launch<Q6KDecoder>(x, w, y, B, N, K, s);
    if (B == 1) return launch<8, 1>(x, w, y, B, N, K, s);
    return launch<16, 8>(x, w, y, B, N, K, s);
}
