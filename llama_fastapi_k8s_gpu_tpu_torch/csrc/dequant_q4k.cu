// Whole-tensor Q4_K -> bf16 or f32 dequantization (the load-time path of
// `token_embd`, whose 128256 x 4096 Q4_K blocks become the bf16 embedding
// table).
//
// Output: bf16 (`token_embd`, and every linear under weight_format=bf16) or
// f32 (the int8 load requantizes from it, as the reference's on-device load
// does from its f32 dequant): the kernel is templated on the output type.
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/dequant.py::_q4_k_kernel
// (launched by dequant_q4_k_device via device_dequant).  The Pallas kernel
// got its per-sub-block scale/min pre-folded on the host; here the kernel
// reads the raw 144-byte GGUF blocks and decodes the f16 headers and the
// 6-bit scales itself, so the load is a plain upload of the file bytes.
//
// Bound on the H100: bytes.  Each 256-element block reads 144 B and writes
// 512 B (bf16), one FMA-free multiply-subtract per element — far below the
// card's ~295 ops/byte balance point.  Design: one 256-thread block per
// super-block, one thread per output element, so the bf16 stores of a warp
// are one contiguous 64-byte run and the 144-byte block is read through L1
// once per block.
//
// Bit-exactness: the numpy codec (gguf/quants.py::dequant_q4_k) rounds
// d*sc, then scale*q, then the subtraction separately.  nvcc would contract
// scale*q - min into one FMA (one rounding), which differs by an ulp, so the
// three steps use the explicitly rounded intrinsics.  The bf16 cast is
// round-to-nearest-even, as torch's and numpy's casts are.
#include "common.cuh"

namespace {

template <typename T>
__global__ void dequant_q4k_kernel(const uint8_t* __restrict__ raw, T* __restrict__ out) {
    const long long blk = blockIdx.x;
    const int t = threadIdx.x;           // element within the super-block
    const uint8_t* b = raw + blk * lfkt::Q4K_BLOCK;
    const int sub = t >> 5;              // 32-element sub-block 0..7
    const int e = t & 31;
    const float d = lfkt::f16_at(b);
    const float dmin = lfkt::f16_at(b + 2);
    int sc, mn;
    lfkt::scale_min_k4(b + 4, sub, sc, mn);
    // byte g*32+e of the nibble area holds sub 2g (low) and 2g+1 (high)
    const uint8_t byte = b[16 + (sub >> 1) * 32 + e];
    const float q = static_cast<float>((sub & 1) ? (byte >> 4) : (byte & 0x0F));
    const float scale = __fmul_rn(d, static_cast<float>(sc));
    const float minv = __fmul_rn(dmin, static_cast<float>(mn));
    const float y = __fsub_rn(__fmul_rn(scale, q), minv);
    lfkt::store_out(out + blk * lfkt::QK_K + t, y);
}

template <typename T>
int launch(const void* raw, void* out, long long n_blocks, cudaStream_t stream) {
    dequant_q4k_kernel<<<dim3(static_cast<unsigned>(n_blocks)), 256, 0, stream>>>(
        static_cast<const uint8_t*>(raw), static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFKT_API int lfkt_dequant_q4k(const void* raw, void* out, long long n_blocks,
                              int out_f32, void* stream) {
    if (n_blocks <= 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    return out_f32 ? launch<float>(raw, out, n_blocks, s)
                   : launch<__nv_bfloat16>(raw, out, n_blocks, s);
}
