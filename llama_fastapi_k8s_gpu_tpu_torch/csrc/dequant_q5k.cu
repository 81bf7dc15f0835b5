// Whole-tensor Q5_K -> bf16 or f32 dequantization: `token_embd` of a
// Q5_K_M file (128256 x 4096) and, under weight_format=bf16 (bf16 out) or
// int8 (f32 out, which the per-row requantize reads), every Q5_K linear
// (4096 x 4096, 1024 x 4096, 14336 x 4096, 4096 x 14336).
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/dequant.py::_q5_k_kernel
// (launched by dequant_q5_k_device via device_dequant).  The Pallas kernel
// got its per-sub-block scale/min pre-folded on the host; here the kernel
// reads the raw 176-byte GGUF blocks (Q4_K's 16-byte header | 32 qh bytes
// | 128 nibble bytes) and decodes the headers and the high bits itself, so
// the load is a plain upload.  Element i of sub-block j (0..7) is
//   q = nibble(qs[(j/2)*32 + i], high if j odd) + 16 * ((qh[i] >> j) & 1)
// and y = d*sc[j]*q - dmin*mn[j].
//
// Bound on the H100: bytes.  A super-block reads 176 B and writes 512 B
// (bf16) or 1024 B (f32).  Design: the Q4_K kernel's (dequant_k4.cuh: a
// warp per super-block, a lane per 16-byte output run, 512 contiguous
// bytes a store instruction), plus one load of the run's qh bytes, from
// which it takes bit j for its sub-block j, as the TPU kernel does.
// Measured, device time from a CUDA graph over the byte bound at the
// loads' five shapes: 1.13-1.58x in bf16, 1.18-1.28x in f32; 128256 x
// 4096 in 0.478-0.559 / 0.869-0.931 ms (NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md §6).
//
// Bit-exact with the numpy codec (gguf/quants.py::dequant_q5_k) and the
// plain version, in bf16 and in f32 (the roundings: dequant_k4.cuh).
#include "dequant_k4.cuh"

LFKT_API int lfkt_dequant_q5k(const void* raw, void* out, long long n_blocks,
                              int out_f32, void* stream) {
    return lfkt::dequant_k4::launch<true>(raw, out, n_blocks, out_f32,
                                          static_cast<cudaStream_t>(stream));
}
