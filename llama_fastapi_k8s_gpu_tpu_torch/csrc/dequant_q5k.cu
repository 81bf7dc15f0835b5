// Whole-tensor Q5_K -> bf16 or f32 dequantization (the load-time path of
// `token_embd` in a Q5_K_M file, whose 128256 x 4096 Q5_K blocks become the
// bf16 embedding table).
//
// Output: bf16 (`token_embd`, and every linear under weight_format=bf16) or
// f32 (the int8 load requantizes from it, as the reference's on-device load
// does from its f32 dequant): the kernel is templated on the output type.
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/dequant.py::_q5_k_kernel
// (launched by dequant_q5_k_device via device_dequant).  The Pallas kernel
// got its per-sub-block scale/min pre-folded on the host; here the kernel
// reads the raw 176-byte GGUF blocks and decodes the f16 headers, the 6-bit
// scales and the high bits itself, so the load is a plain upload.
//
// Bound on the H100: bytes.  Each 256-element block reads 176 B and writes
// 512 B (bf16), two multiplies and a subtraction per element.  Design, as
// dequant_q4k.cu: one 256-thread block per super-block, one thread per
// output element, so a warp stores one contiguous 64-byte run and the
// block's bytes are read through L1 once per block.
//
// Element i of sub-block j (0..7) is
//   q = nibble(qs[(j/2)*32 + i], high if j odd) + 16 * ((qh[i] >> j) & 1)
// and y = d*sc[j]*q - dmin*mn[j].
//
// Bit-exactness: the numpy codec (gguf/quants.py::dequant_q5_k) rounds
// d*sc, then scale*q, then the subtraction separately; the explicitly
// rounded intrinsics keep nvcc from contracting scale*q - min into one FMA.
// The bf16 cast is round-to-nearest-even, as torch's and numpy's casts are.
#include "common.cuh"

namespace {

template <typename T>
__global__ void dequant_q5k_kernel(const uint8_t* __restrict__ raw, T* __restrict__ out) {
    const long long blk = blockIdx.x;
    const int t = threadIdx.x;           // element within the super-block
    const uint8_t* b = raw + blk * lfkt::Q5K_BLOCK;
    const int sub = t >> 5;              // 32-element sub-block 0..7
    const int e = t & 31;
    const float d = lfkt::f16_at(b);
    const float dmin = lfkt::f16_at(b + 2);
    int sc, mn;
    lfkt::scale_min_k4(b + 4, sub, sc, mn);
    const uint8_t byte = b[48 + (sub >> 1) * 32 + e];
    const int nib = (sub & 1) ? (byte >> 4) : (byte & 0x0F);
    const int hb = (b[16 + e] >> sub) & 1;
    const float q = static_cast<float>(nib + 16 * hb);
    const float scale = __fmul_rn(d, static_cast<float>(sc));
    const float minv = __fmul_rn(dmin, static_cast<float>(mn));
    const float y = __fsub_rn(__fmul_rn(scale, q), minv);
    lfkt::store_out(out + blk * lfkt::QK_K + t, y);
}

template <typename T>
int launch(const void* raw, void* out, long long n_blocks, cudaStream_t stream) {
    dequant_q5k_kernel<<<dim3(static_cast<unsigned>(n_blocks)), 256, 0, stream>>>(
        static_cast<const uint8_t*>(raw), static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFKT_API int lfkt_dequant_q5k(const void* raw, void* out, long long n_blocks,
                              int out_f32, void* stream) {
    if (n_blocks <= 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    return out_f32 ? launch<float>(raw, out, n_blocks, s)
                   : launch<__nv_bfloat16>(raw, out, n_blocks, s);
}
