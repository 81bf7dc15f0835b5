// Whole-tensor Q6_K -> bf16 or f32 dequantization (the load-time path of
// `token_embd` in a Q6_K file, whose 128256 x 4096 Q6_K blocks become the
// bf16 embedding table).
//
// Output: bf16 (`token_embd`, and every linear under weight_format=bf16) or
// f32 (the int8 load requantizes from it, as the reference's on-device load
// does from its f32 dequant): the kernel is templated on the output type.
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/dequant.py::_q6_k_kernel
// (launched by dequant_q6_k_device via device_dequant).  The Pallas kernel
// got the 6-bit values unpacked to int8 and the scales folded (d * sc) on
// the host; here the kernel reads the raw 210-byte GGUF blocks and does
// both itself, so the load is a plain upload.
//
// Bound on the H100: bytes.  Each 256-element block reads 210 B and writes
// 512 B (bf16).  Design: one warp per super-block, 8 super-blocks per
// block; lane l owns elements l*8 .. l*8+7, which sit in one 16-element
// sub-block, one 8-byte run of ql and one of qh (the decode of
// q6k_matmul.cu), and stores its 8 bf16 as one 16-byte write, so a warp
// writes its block's 512 contiguous bytes.  A 210-byte block is only
// 2-byte aligned, so the runs are read as four 16-bit words each
// (load8_a2).
//
// Element i = h*128 + r (half h, r < 128) of a block is
//   q6 = ((ql[h*64 + r%64] >> (r < 64 ? 0 : 4)) & 15)
//        | (((qh[h*32 + r%32] >> 2*(r/32)) & 3) << 4)
// and y = (d * sc[i/16]) * (q6 - 32).
//
// Bit-exactness: the numpy codec (gguf/quants.py::dequant_q6_k) rounds
// d*sc, then the product with q6-32, each in f32; the explicitly rounded
// intrinsics keep nvcc from fusing them.  The bf16 cast is
// round-to-nearest-even, as torch's and numpy's casts are.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
dequant_q6k_kernel(const uint8_t* __restrict__ raw, T* __restrict__ out, long long n_blocks) {
    const long long blk = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
    if (blk >= n_blocks) return;
    const int lane = threadIdx.x & 31;
    const uint8_t* b = raw + blk * lfkt::Q6K_BLOCK;
    const int h = lane >> 4;
    const int r0 = (lane & 15) * 8;
    const int ql_shift = (r0 >= 64) ? 4 : 0;
    const int qh_shift = 2 * (r0 >> 5);
    uint32_t l0, l1, h0, h1;
    lfkt::load8_a2(b + h * 64 + (r0 & 63), l0, l1);
    lfkt::load8_a2(b + 128 + h * 32 + (r0 & 31), h0, h1);
    const float scale = __fmul_rn(lfkt::f16_at(b + 208),
                                  static_cast<float>(static_cast<int8_t>(b[192 + (lane >> 1)])));
    float y[8];                          // elements lane*8 + 0..7
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int a0 = ((l0 >> (8 * k + ql_shift)) & 0x0F) | (((h0 >> (8 * k + qh_shift)) & 3) << 4);
        const int a1 = ((l1 >> (8 * k + ql_shift)) & 0x0F) | (((h1 >> (8 * k + qh_shift)) & 3) << 4);
        y[k] = __fmul_rn(scale, static_cast<float>(a0 - 32));
        y[k + 4] = __fmul_rn(scale, static_cast<float>(a1 - 32));
    }
    lfkt::store8(out + blk * lfkt::QK_K + lane * 8, y);
}

template <typename T>
int launch(const void* raw, void* out, long long n_blocks, cudaStream_t stream) {
    const long long grid = (n_blocks + WARPS - 1) / WARPS;
    dequant_q6k_kernel<<<dim3(static_cast<unsigned>(grid)), WARPS * 32, 0, stream>>>(
        static_cast<const uint8_t*>(raw), static_cast<T*>(out), n_blocks);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFKT_API int lfkt_dequant_q6k(const void* raw, void* out, long long n_blocks,
                              int out_f32, void* stream) {
    if (n_blocks <= 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    return out_f32 ? launch<float>(raw, out, n_blocks, s)
                   : launch<__nv_bfloat16>(raw, out, n_blocks, s);
}
