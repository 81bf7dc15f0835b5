// Whole-tensor Q4_K -> bf16 or f32 dequantization: `token_embd` of a
// Q4_K_M file (128256 x 4096) and, under weight_format=bf16 (bf16 out) or
// int8 (f32 out, which the per-row requantize reads, as the reference's
// on-device load reads its f32 dequant), every Q4_K linear (4096 x 4096,
// 1024 x 4096, 14336 x 4096, 4096 x 14336).
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/dequant.py::_q4_k_kernel
// (launched by dequant_q4_k_device via device_dequant).  The Pallas kernel
// got its per-sub-block scale/min pre-folded on the host and wrote 128-lane
// planes of low and high nibbles; here the kernel reads the raw 144-byte
// GGUF blocks (f16 d | f16 dmin | 12 packed 6-bit scales and mins | 128
// nibble bytes) and decodes the headers itself, so the load is a plain
// upload of the file bytes.  Like the TPU kernel it reads each nibble byte
// from memory once: its low nibble is element i of sub-block 2g, its high
// nibble element i of 2g + 1.
//
// Bound on the H100: bytes.  A super-block reads 144 B and writes 512 B
// (bf16) or 1024 B (f32), one multiply-add an element.  Design
// (dequant_k4.cuh): a warp per super-block, a lane per 16-byte
// output run (8 elements in bf16, two runs of 4 in f32) inside one
// sub-block, so every store instruction of a warp writes 512 contiguous
// bytes; one 16-byte header load, one nibble load and one scale decode
// (lfkt::scale_min_k4 on the header's words) a run; indexed by a shift.
// Measured, device time from a CUDA graph over the byte bound at the
// loads' five shapes: 1.14-1.63x in bf16, 1.16-1.28x in f32; 128256 x
// 4096 in 0.457-0.459 / 0.827-0.894 ms (NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md §6).
//
// Bit-exact with the numpy codec (gguf/quants.py::dequant_q4_k) and the
// plain version, in bf16 and in f32 (the roundings: dequant_k4.cuh).
#include "dequant_k4.cuh"

LFKT_API int lfkt_dequant_q4k(const void* raw, void* out, long long n_blocks,
                              int out_f32, void* stream) {
    return lfkt::dequant_k4::launch<false>(raw, out, n_blocks, out_f32,
                                           static_cast<cudaStream_t>(stream));
}
