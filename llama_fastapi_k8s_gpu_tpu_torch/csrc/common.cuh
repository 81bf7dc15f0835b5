// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes one `extern "C"` launcher that takes raw device
// pointers plus the CUDA stream as `void*` and returns the launch status
// (cudaGetLastError() right after the launch) as an int: 0 is success, and
// the Python wrapper raises on anything else.  Launchers never allocate and
// never synchronise.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define LFKT_API extern "C" __attribute__((visibility("default")))

namespace lfkt {

constexpr int QK_K = 256;          // K-quant super-block (elements)
constexpr int Q4K_BLOCK = 144;     // f16 d | f16 dmin | 12 B scales | 128 B nibbles
constexpr int Q5K_BLOCK = 176;     // Q4_K's 16 B header | 32 B qh | 128 B nibbles
constexpr int Q6K_BLOCK = 210;     // 128 B ql | 64 B qh | 16 x i8 scales | f16 d
constexpr int QK8_0 = 32;          // Q8_0 block (elements)
constexpr int Q8_0_BLOCK = 34;     // f16 d | 32 x i8

__device__ __forceinline__ float f16_at(const uint8_t* p) {
    // 2-byte aligned little-endian IEEE half
    return __half2float(*reinterpret_cast<const __half*>(p));
}

// 8 bytes at a 2-byte aligned address, as four 16-bit loads (Q6_K and
// Q8_0 blocks are only 2-byte aligned: 210 and 34 are not multiples of 4)
__device__ __forceinline__ void load8_a2(const uint8_t* p, uint32_t& lo, uint32_t& hi) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
    lo = static_cast<uint32_t>(h[0]) | (static_cast<uint32_t>(h[1]) << 16);
    hi = static_cast<uint32_t>(h[2]) | (static_cast<uint32_t>(h[3]) << 16);
}

// the bf16 pair (low, high) of a 32-bit word as floats
__device__ __forceinline__ float lo_bf(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// 8 consecutive dequantized values at a 16-byte aligned address: one
// 16-byte store in bf16 (round to nearest even), two in f32
__device__ __forceinline__ void store8(__nv_bfloat16* out, const float* y) {
    uint32_t b[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = __bfloat16_as_ushort(__float2bfloat16_rn(y[k]));
    *reinterpret_cast<uint4*>(out) =
        make_uint4(b[0] | (b[1] << 16), b[2] | (b[3] << 16), b[4] | (b[5] << 16), b[6] | (b[7] << 16));
}

__device__ __forceinline__ void store8(float* out, const float* y) {
    reinterpret_cast<float4*>(out)[0] = make_float4(y[0], y[1], y[2], y[3]);
    reinterpret_cast<float4*>(out)[1] = make_float4(y[4], y[5], y[6], y[7]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// The int8 KV cache's quantize of one head row (csrc/kv_quantize.cu, and the
// ring write of csrc/decode_loop.cu), bit-exact with the reference's
// quantize_kv_xla: the scale s = max|x| / 127 over the row (one warp holds
// the row: `lane_amax` is the lane's part of the max) and inv = 1 / s, both
// IEEE-rounded (0 for an all-zero row, whose values then quantize to 0)...
__device__ __forceinline__ float kv_row_scale(float lane_amax, float& inv) {
    const float s = __fdiv_rn(warp_max(lane_amax), 127.0f);
    inv = s > 0.f ? __frcp_rn(s) : 0.f;
    return s;
}

// ...then q = clip(round_half_even(x * inv), -127, 127): rintf rounds half to
// even as jnp.round does (roundf would round half away from zero).
__device__ __forceinline__ int8_t kv_quantize_value(float x, float inv) {
    const float y = rintf(__fmul_rn(x, inv));
    return static_cast<int8_t>(fminf(fmaxf(y, -127.f), 127.f));
}

// The interleaved RoPE of pair i of a head row (elements 2i, 2i+1), from
// the pass's table (c, s = cos, sin of the angle): (x1, x2) -> (o1, o2),
// each rounded to bf16 as the plain path casts its result.  Every product
// and the sum are rounded on their own, as the plain path's f32 torch ops
// round them (nvcc would contract x1*c - x2*s into an FMA).
__device__ __forceinline__ void rope_pair(float x1, float x2, float c, float s, float& o1,
                                          float& o2) {
    o1 = __bfloat162float(__float2bfloat16_rn(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s))));
    o2 = __bfloat162float(__float2bfloat16_rn(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c))));
}

// get_scale_min_k4: the 6-bit scale and min of sub-block j (0..7) from the
// 12 packed bytes of a Q4_K/Q5_K super-block header.
__device__ __forceinline__ void scale_min_k4(const uint8_t* s, int j, int& sc, int& mn) {
    if (j < 4) {
        sc = s[j] & 63;
        mn = s[j + 4] & 63;
    } else {
        sc = (s[j + 4] & 0x0F) | ((s[j - 4] >> 6) << 4);
        mn = (s[j + 4] >> 4) | ((s[j] >> 6) << 4);
    }
}

// The same from the 12 packed bytes held in registers as three
// little-endian words: s0 = bytes 0..3, s1 = 4..7, s2 = 8..11.
__device__ __forceinline__ void scale_min_k4(uint32_t s0, uint32_t s1, uint32_t s2, int j,
                                             int& sc, int& mn) {
    const int sh = 8 * (j & 3);
    const int a = (s0 >> sh) & 0xFF;     // s[j & 3]
    const int b = (s1 >> sh) & 0xFF;     // s[(j & 3) + 4]
    const int c = (s2 >> sh) & 0xFF;     // s[(j & 3) + 8]
    if (j < 4) {
        sc = a & 63;
        mn = b & 63;
    } else {
        sc = (c & 0x0F) | ((a >> 6) << 4);
        mn = (c >> 4) | ((b >> 6) << 4);
    }
}

}  // namespace lfkt
