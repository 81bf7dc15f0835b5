// Whole-tensor Q8_0 -> bf16 or f32 dequantization (the load-time path of
// `token_embd` in a Q8_0 file, whose 128256 x 4096 Q8_0 blocks become the
// bf16 embedding table).
//
// Output: bf16 (`token_embd`, and every linear under weight_format=bf16) or
// f32 (the int8 load requantizes from it, as the reference's on-device load
// does from its f32 dequant): the kernel is templated on the output type.
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/dequant.py::_q8_0_kernel
// (launched by dequant_q8_0_device via device_dequant).  The Pallas kernel
// got the f16 block scales converted on the host and the int8 payload
// regrouped into 128-lane rows; here the kernel reads the raw 34-byte GGUF
// blocks, so the load is a plain upload.
//
// Bound on the H100: bytes.  Each 32-element block reads 34 B and writes
// 64 B (bf16), one multiply per element.  Design: one thread per output
// element, 256 threads (8 blocks) per CUDA block, so a warp reads one
// block's 32 payload bytes and stores one contiguous 64-byte run.  A
// 34-byte block is only 2-byte aligned, so the payload is read byte by byte
// and the f16 scale as one 16-bit load.
//
// Bit-exactness: y = d*q is one f32 rounding (exact, in fact: an 11-bit
// mantissa times an 8-bit integer), as in the numpy codec
// (gguf/quants.py::dequant_q8_0); the bf16 cast is round-to-nearest-even.
#include "common.cuh"

namespace {

template <typename T>
__global__ void dequant_q8_0_kernel(const uint8_t* __restrict__ raw, T* __restrict__ out,
                                    long long n) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint8_t* b = raw + (i / lfkt::QK8_0) * lfkt::Q8_0_BLOCK;
    const float d = lfkt::f16_at(b);
    const float q = static_cast<float>(static_cast<int8_t>(b[2 + i % lfkt::QK8_0]));
    lfkt::store_out(out + i, __fmul_rn(d, q));
}

template <typename T>
int launch(const void* raw, void* out, long long n_blocks, cudaStream_t stream) {
    const long long n = n_blocks * lfkt::QK8_0;
    dequant_q8_0_kernel<<<dim3(static_cast<unsigned>((n + 255) / 256)), 256, 0, stream>>>(
        static_cast<const uint8_t*>(raw), static_cast<T*>(out), n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFKT_API int lfkt_dequant_q8_0(const void* raw, void* out, long long n_blocks,
                               int out_f32, void* stream) {
    if (n_blocks <= 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    return out_f32 ? launch<float>(raw, out, n_blocks, s)
                   : launch<__nv_bfloat16>(raw, out, n_blocks, s);
}
