// Whole-tensor Q8_0 -> bf16 dequantization (the load-time path of
// `token_embd` in a Q8_0 file, whose 128256 x 4096 Q8_0 blocks become the
// bf16 embedding table).
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

__global__ void dequant_q8_0_kernel(const uint8_t* __restrict__ raw,
                                    __nv_bfloat16* __restrict__ out, long long n) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint8_t* b = raw + (i / lfkt::QK8_0) * lfkt::Q8_0_BLOCK;
    const float d = lfkt::f16_at(b);
    const float q = static_cast<float>(static_cast<int8_t>(b[2 + i % lfkt::QK8_0]));
    out[i] = __float2bfloat16_rn(__fmul_rn(d, q));
}

}  // namespace

LFKT_API int lfkt_dequant_q8_0(const void* raw, void* out, long long n_blocks,
                               void* stream) {
    if (n_blocks <= 0) return 0;
    const long long n = n_blocks * lfkt::QK8_0;
    dequant_q8_0_kernel<<<dim3(static_cast<unsigned>((n + 255) / 256)), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(raw), static_cast<__nv_bfloat16*>(out), n);
    return static_cast<int>(cudaGetLastError());
}
