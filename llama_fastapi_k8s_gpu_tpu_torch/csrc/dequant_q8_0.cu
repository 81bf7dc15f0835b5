// Whole-tensor Q8_0 -> bf16 or f32 dequantization: `token_embd` of a Q8_0
// file (128256 x 4096) and, under weight_format=bf16, every linear of one
// (4096 x 4096, 1024 x 4096, 14336 x 4096, 4096 x 14336 and the output head).
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
// 64 B (bf16) or 128 B (f32), one multiply per element.  A thread per
// element (a 64-bit divide and modulo, a 2-byte load of d, a byte load of q
// and a 2-byte store each: three memory instructions an element, 64 bytes a
// warp store) takes 3.1x the bound in bf16 on the H100.  Design
// (the layout of dequant_q6k.cu, which reads more bytes a weight and runs
// 2.7x faster than that): a lane decodes one contiguous run of 8 elements of one
// block, 4 lanes a block.  Its 8 payload bytes come as four 16-bit loads
// (load8_a2: a 34-byte block is only 2-byte aligned, so no wider load is
// safe), its scale d as one, and its 8 results go out as one 16-byte store
// in bf16, two in f32 (store8), so a warp writes 512 (1024) contiguous
// bytes.  Indexed by block (a shift, not a divide); 256 threads a CUDA block, so
// the 1024 x 4096 tensor (131072 blocks) is 2048 CUDA blocks, about two
// waves of the 132 SMs.
//
// Bit-exactness: y = d*q is one f32 rounding (exact, in fact: an 11-bit
// mantissa times an 8-bit integer), as in the numpy codec
// (gguf/quants.py::dequant_q8_0); the bf16 cast is round-to-nearest-even.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LANES_PER_BLOCK = lfkt::QK8_0 / 8;     // 4 runs of 8 elements

template <typename T>
__global__ void __launch_bounds__(THREADS)
dequant_q8_0_kernel(const uint8_t* __restrict__ raw, T* __restrict__ out, long long n_blocks) {
    const long long run = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    const long long blk = run / LANES_PER_BLOCK;
    if (blk >= n_blocks) return;
    const int j = static_cast<int>(run % LANES_PER_BLOCK);   // run within the block
    const uint8_t* b = raw + blk * lfkt::Q8_0_BLOCK;
    uint32_t lo, hi;
    lfkt::load8_a2(b + 2 + 8 * j, lo, hi);
    const float d = lfkt::f16_at(b);
    float y[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        y[e] = __fmul_rn(d, static_cast<float>(static_cast<int8_t>(lo >> (8 * e))));
        y[e + 4] = __fmul_rn(d, static_cast<float>(static_cast<int8_t>(hi >> (8 * e))));
    }
    lfkt::store8(out + blk * lfkt::QK8_0 + 8 * j, y);
}

template <typename T>
int launch(const void* raw, void* out, long long n_blocks, cudaStream_t stream) {
    const long long grid = (n_blocks * LANES_PER_BLOCK + THREADS - 1) / THREADS;
    dequant_q8_0_kernel<<<dim3(static_cast<unsigned>(grid)), THREADS, 0, stream>>>(
        static_cast<const uint8_t*>(raw), static_cast<T*>(out), n_blocks);
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
