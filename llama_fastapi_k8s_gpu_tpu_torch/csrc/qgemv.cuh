// CUDA-core matrix-vector path over GGUF block rows, the decode-step path of
// the fused dequant-matmuls: y (B, N) bf16 = x (B, K) bf16 . W^T for a few
// activation rows (B below the route's threshold, qmma_route.cu; any B for a
// Q8_0 weight whose K is not whole 256-element groups), with W (N, K) held
// as the file's own blocks.  f32 accumulation, a bf16 result.  The format
// lives in a decoder (Q4KGemv in q4k_matmul.cu, Q5KGemv in q5k_matmul.cu,
// Q6KGemv in q6k_matmul.cu, Q8Gemv in q8_matmul.cu); the loop, the row
// template and the split-K reduction here are format-free.
//
// Bound on the H100: bytes.  At B = 1 every weight byte is read once and
// used for one multiply-add (Q4_K: 0.5625 bytes a weight, Q5_K: 0.6875,
// Q6_K: 0.8203, Q8_0: 1.0625), so the card streams the weight at 3.35
// TB/s only if enough bytes are in flight (Little's law: ~1 us of loaded
// DRAM latency x 3.35 TB/s / 132 SMs, 20-25 KB an SM) and the decode keeps
// pace: at Q4_K's byte rate the SMs have ~5 instructions a weight to
// spend.  The design:
//   - no barrier in the loop over K: a warp walks K in steps of Dec::STEP
//     elements; in a step each lane holds 16-byte units of weight bytes
//     (streamed: read once) for NR = 2 weight rows, in a ring of
//     Dec::AHEAD steps whose loads fly while an earlier step is decoded
//     (a slot is refilled before its step's decode where the decoder
//     copies the bytes out, after it where it reads them in place);
//   - whole rows (N large): one wave of blocks, warp gw taking row pairs
//     gw, gw + GW, ... from the first step to the last, the loads running
//     ahead across pairs, so a warp pays the memory latency once, not once
//     a row;
//   - small N fills the card by splitting K over the warps of a block
//     instead (kw = 2, 4 or 8 warps a row pair, chosen at launch so that
//     about 12 warps an SM have work: 4096 rows, 15.5 pairs an SM, take
//     whole rows in one wave, which beats split K in two waves of blocks
//     that each copy x), each warp taking every kw-th step;
//     the partial sums meet once, after the loop, in shared memory, in a
//     fixed order: no atomics, so a result does not depend on the schedule;
//   - a lane's unit decodes into 16-element segments, each with a scale a
//     and a min m: acc += a * sum(q * x) - m * sum(x) (m = 0 for Q8_0),
//     sum(q * x) and sum(x) in f32 (the scales stay exact f32: d * sc,
//     dmin * mn); x is fetched once per segment for both weight rows, each
//     decoded weight is reused by the RB activation rows in registers;
//   - x: a lane's 16-element runs lie 64 or 128 bytes apart across the
//     lanes, so reading them from global memory costs one L1 wavefront per
//     lane (32 a load, where 4 would carry the bytes), a large share of
//     the decode's time on the H100.  So where the RB rows fit 64 KB
//     (every decode step at the 8B shapes) a block copies x once, before
//     the loop, into shared memory as f32 with its 16-element sums — the
//     one barrier, outside the loop over K — and the lanes read it with
//     16-byte loads swizzled by their runs (no bank conflict), with no
//     conversion and no sum left in the loop; larger RB x K read x from
//     global memory through the read-only path (16-byte loads);
//   - RB (1, 2, 4 or 8) activation rows a block, rows past B masked;
//     B above 8 loops over row groups by grid.y;
//   - loads 16 bytes wide where the weight's base and row stride and x's
//     base allow (every 8B shape), else as narrow as the wrapper's
//     alignment (8 bytes Q4_K and Q5_K, 2 Q6_K and Q8_0; x as 16-bit
//     words): chosen at launch.
#pragma once

#include <algorithm>
#include <type_traits>

#include "qmma.cuh"

namespace lfkt {
namespace qgemv {

constexpr int WARPS = 8;               // warps a block
constexpr int NR = 2;                  // weight rows a warp
constexpr int SEG = 16;                // elements of a segment
constexpr int FILL_WARPS_PER_SM = 12;  // warps with work that fill an SM
constexpr size_t XS_MAX_BYTES = 64 * 1024;   // largest f32 copy of x a block stages

// weight bytes, read once a call: streamed past the caches
__device__ __forceinline__ uint4 ld_stream16(const uint8_t* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ uint2 ld_stream8(const uint8_t* p) {
    return __ldcs(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ uint32_t ld_stream2(const uint8_t* p) {
    return __ldcs(reinterpret_cast<const unsigned short*>(p));
}

// 4W bytes at byte offset `off` (even) of a 4-byte aligned buffer in
// shared memory, as W words: W + 1 aligned loads, shifted by 16 bits when
// off is not a multiple of 4 (the last word read may lie up to 4 bytes
// past the 4W)
template <int W>
__device__ __forceinline__ void load_a2(const uint8_t* base, int off, uint32_t (&v)[W]) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(base + (off & ~3));
    const uint32_t sh = static_cast<uint32_t>(off & 2) * 8;
    uint32_t lo = w[0];
#pragma unroll
    for (int i = 0; i < W; ++i) {
        const uint32_t hi = w[i + 1];
        v[i] = __funnelshift_r(lo, hi, sh);
        lo = hi;
    }
}

// 16 bf16 of x at p as f32, through the read-only path: two 16-byte loads,
// or sixteen 16-bit ones where x is not 16-byte aligned
template <bool A16>
__device__ __forceinline__ void load_x16(const __nv_bfloat16* p, float (&f)[SEG]) {
    uint32_t v[8];
    if constexpr (A16) {
        const uint4* q = reinterpret_cast<const uint4*>(p);
        const uint4 a = __ldg(q), b = __ldg(q + 1);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
        const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
        for (int i = 0; i < 8; ++i)
            v[i] = static_cast<uint32_t>(__ldg(h + 2 * i)) |
                   (static_cast<uint32_t>(__ldg(h + 2 * i + 1)) << 16);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        f[2 * i] = __uint_as_float(v[i] << 16);
        f[2 * i + 1] = __uint_as_float(v[i] & 0xFFFF0000u);
    }
}

// 16-byte chunk c of a row of x staged in shared memory: XOR-swizzled by
// its run of 2^sw chunks (a lane's run), so that the lanes of an 8-lane
// phase reading chunk k of their runs hit eight distinct bank groups
__device__ __forceinline__ int xs_chunk(int c, int sw) { return c ^ ((c >> sw) & 7); }

// One step's decoded units of the warp's NR weight rows into the RB
// activation rows' sums: per segment, the NR rows' weights decoded once;
// per activation row, its 16 x values (and their sum) fetched once — from
// the block's f32 copy of x in shared memory (XS), or converted from
// global memory.  A decoder may hand its q out as Q0 + q * 2^-k (a bit
// pattern one byte permute makes, with no subtraction) and its scale a
// times 2^k: then sum(q * x) * 2^-k = sum((Q0 + q 2^-k) x) - Q0 * sum(x).
template <class Dec, int RB, bool A16, bool XS>
__device__ __forceinline__ void accumulate(const typename Dec::Unit (&u)[NR],
                                           const typename Dec::template Raw<A16> (&r)[NR],
                                           float (&acc)[NR][RB],
                                           const __nv_bfloat16* __restrict__ x,
                                           const float* xsm, int B, int b0, int K, int s,
                                           int lane) {
#pragma unroll
    for (int g = 0; g < Dec::SEGS; ++g) {
        float q[NR][SEG], a[NR], m[NR];
#pragma unroll
        for (int n = 0; n < NR; ++n) Dec::segment(u[n], r[n], g, q[n], a[n], m[n]);
        const int off = Dec::x_offset(s, lane, g, K);
#pragma unroll
        for (int b = 0; b < RB; ++b) {
            if (b > 0 && b0 + b >= B) break;             // row b0 is always in range
            float xf[SEG];
            float sx = 0.f;
            if constexpr (XS) {
                const float* row = xsm + b * K;
#pragma unroll
                for (int k = 0; k < SEG; k += 4) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        row + 4 * xs_chunk((off + k) >> 2, Dec::XSW));
                    xf[k] = v.x; xf[k + 1] = v.y; xf[k + 2] = v.z; xf[k + 3] = v.w;
                }
                if constexpr (Dec::MIN) sx = xsm[RB * K + b * (K / SEG) + off / SEG];
            } else {
                load_x16<A16>(x + static_cast<size_t>(b0 + b) * K + off, xf);
                if constexpr (Dec::MIN) {
#pragma unroll
                    for (int k = 0; k < SEG; ++k) sx += xf[k];
                }
            }
#pragma unroll
            for (int n = 0; n < NR; ++n) {
                float sqx = 0.f;
#pragma unroll
                for (int k = 0; k < SEG; ++k) sqx = fmaf(q[n][k], xf[k], sqx);
                if constexpr (Dec::MIN) {
                    if constexpr (Dec::Q0 != 0.f) sqx = fmaf(-Dec::Q0, sx, sqx);
                    acc[n][b] += a[n] * sqx - m[n] * sx;
                } else {
                    acc[n][b] = fmaf(a[n], sqx, acc[n][b]);
                }
            }
        }
    }
}

// A warp's work as (row pair, step) items, in order.  Split K (kw > 1): the
// block's WARPS / kw row pairs, kw warps a pair, the warp taking steps
// part, part + kw, ... of its pair.  Otherwise whole rows: warp gw of the
// grid takes pairs gw, gw + GW, ... (GW warps in the grid), each from step
// 0 to the last — the loads run ahead across pairs, so a warp pays the
// memory latency once, not once a row.
struct Cursor {
    int p, s;
    __device__ __forceinline__ void advance(int kw, int steps, int stride) {
        if (kw > 1) {
            s += kw;
        } else if (++s == steps) {
            s = 0;
            p += stride;
        }
    }
};

template <class Dec, int RB, bool A16, bool XS>
__global__ void __launch_bounds__(WARPS * 32, RB <= 2 ? 2 : 1)
qgemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
             __nv_bfloat16* __restrict__ y, int B, int N, int K, int kw) {
    using Raw = typename Dec::template Raw<A16>;
    using Unit = typename Dec::Unit;
    constexpr int AHEAD = Dec::AHEAD;
    __shared__ float red[WARPS][NR * RB];
    // the decoder's per-warp exchange buffer, 16 bytes of slack for the
    // last word of an unaligned read
    __shared__ __align__(16) uint8_t stage[WARPS][Dec::STAGE + 16];

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b0 = blockIdx.y * RB;
    const size_t row_bytes = static_cast<size_t>(K / Dec::ELEMS) * Dec::BYTES;
    const int steps = (K + Dec::STEP - 1) / Dec::STEP;
    const int pairs = (N + NR - 1) / NR;
    const int part = warp % kw;
    int items, stride = 0;
    Cursor ld;
    if (kw > 1) {
        ld = {static_cast<int>(blockIdx.x) * (WARPS / kw) + warp / kw, part};
        items = ld.p < pairs && part < steps ? (steps - part + kw - 1) / kw : 0;
    } else {
        stride = gridDim.x * WARPS;
        ld = {static_cast<int>(blockIdx.x) * WARPS + warp, 0};
        items = ld.p < pairs ? (pairs - ld.p + stride - 1) / stride * steps : 0;
    }
    Cursor cu = ld;
    auto load = [&](Raw (&r)[NR], const Cursor& c) {
#pragma unroll
        for (int n = 0; n < NR; ++n)
            Dec::template load<A16>(
                r[n], w + static_cast<size_t>(min(c.p * NR + n, N - 1)) * row_bytes,  // past N: any row
                c.s, lane, K);
    };

    float acc[NR][RB];
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int b = 0; b < RB; ++b) acc[n][b] = 0.f;
    // lane t writes sum t = (row t / RB, activation row t % RB) of pair p
    auto flush = [&](int p, float v) {
        const int n = p * NR + lane / RB, b = b0 + lane % RB;
        if (lane < NR * RB && n < N && b < B)
            y[static_cast<size_t>(b) * N + n] = __float2bfloat16_rn(v);
    };
    auto lane_sum = [&]() {
        float v = 0.f;
#pragma unroll
        for (int n = 0; n < NR; ++n)
#pragma unroll
            for (int b = 0; b < RB; ++b) {
                const float r = warp_sum(acc[n][b]);
                if (lane == n * RB + b) v = r;
                acc[n][b] = 0.f;
            }
        return v;
    };

    Raw raw[AHEAD][NR];
#pragma unroll
    for (int a = 0; a < AHEAD; ++a)
        if (a < items) {
            load(raw[a], ld);
            ld.advance(kw, steps, stride);
        }
    // XS: the RB rows of x as f32 (swizzled chunks) and their 16-element
    // sums, once a block, while the first loads fly; the one barrier
    // before the loop
    extern __shared__ __align__(16) float xsm[];
    if constexpr (XS) {
        const int segs = K / SEG;
        for (int i = threadIdx.x; i < RB * segs; i += WARPS * 32) {
            const int b = i / segs, e = (i - b * segs) * SEG;
            float f[SEG];
            if (b0 + b < B) {
                load_x16<A16>(x + static_cast<size_t>(b0 + b) * K + e, f);
            } else {
#pragma unroll
                for (int k = 0; k < SEG; ++k) f[k] = 0.f;
            }
            float sum = 0.f;
#pragma unroll
            for (int k = 0; k < SEG; k += 4) {
                *reinterpret_cast<float4*>(xsm + b * K + 4 * xs_chunk((e + k) >> 2, Dec::XSW)) =
                    make_float4(f[k], f[k + 1], f[k + 2], f[k + 3]);
                sum += f[k] + f[k + 1] + f[k + 2] + f[k + 3];
            }
            xsm[RB * K + i] = sum;
        }
        __syncthreads();
    }
    for (int i = 0; i < items; i += AHEAD) {
#pragma unroll
        for (int a = 0; a < AHEAD; ++a) {
            const int t = i + a;
            if (t >= items) break;
            Unit u[NR];
            Dec::template unpack<A16>(raw[a], u, lane, stage[warp], cu.s, K);  // every lane
            // refill: before decoding where the unit holds its own copy of
            // the weights (Dec::REFILL_EARLY), else after, from raw itself
            const bool refill = t + AHEAD < items;
            if (Dec::REFILL_EARLY && refill) {
                load(raw[a], ld);
                ld.advance(kw, steps, stride);
            }
            accumulate<Dec, RB, A16, XS>(u, raw[a], acc, x, xsm, B, b0, K, cu.s, lane);
            if (!Dec::REFILL_EARLY && refill) {
                load(raw[a], ld);
                ld.advance(kw, steps, stride);
            }
            if (kw == 1 && cu.s == steps - 1) flush(cu.p, lane_sum());
            cu.advance(kw, steps, stride);
        }
    }
    if (kw > 1) {                                          // split K: meet once, in order
        float v = lane_sum();
        if (lane < NR * RB) red[warp][lane] = v;
        __syncthreads();
        if (part != 0 || items == 0) return;
        if (lane < NR * RB)
            for (int k = 1; k < kw; ++k) v += red[warp + k][lane];
        flush(cu.p, v);
    }
}

inline int sms() {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    static int cached[64] = {};
    if (dev >= 64) return qmma::sm_count();
    if (cached[dev] == 0) cached[dev] = qmma::sm_count();
    return cached[dev];
}

// bytes of shared memory the block's f32 copy of x (XS) takes
template <int RB>
inline size_t xs_bytes(int K) { return static_cast<size_t>(RB) * (K + K / SEG) * sizeof(float); }

template <class Dec, int RB, bool A16, bool XS>
int launch_k(const void* x, const void* w, void* y, int B, int N, int K, cudaStream_t s) {
    auto kern = qgemv_kernel<Dec, RB, A16, XS>;
    const size_t dyn = XS ? xs_bytes<RB>(K) : 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    // above 48 KB of dynamic shared memory a kernel must opt in, per device
    static unsigned long long configured = 0;        // one bit per device
    if (XS && (dev >= 64 || !(configured >> dev & 1ull))) {
        e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(XS_MAX_BYTES));
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     static_cast<int>(cudaSharedmemCarveoutMaxShared));
        if (e != cudaSuccess) return static_cast<int>(e);
        if (dev < 64) configured |= 1ull << dev;
    }
    // resident blocks an SM: the registers' limit (once), and the shared
    // memory's at this K
    static int reg_blocks = 0;
    static size_t static_smem = 0;
    if (reg_blocks == 0) {
        cudaFuncAttributes fa;
        e = cudaFuncGetAttributes(&fa, kern);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&reg_blocks, kern, WARPS * 32, 0);
        if (e != cudaSuccess) return static_cast<int>(e);
        static_smem = fa.sharedSizeBytes;
        reg_blocks = reg_blocks > 0 ? reg_blocks : 1;
    }
    const int per_sm = std::max(1, std::min(reg_blocks, static_cast<int>(
        qmma::SMEM_SM / (dyn + static_smem + qmma::SMEM_RESERVED))));
    const int steps = (K + Dec::STEP - 1) / Dec::STEP;
    const int gy = (B + RB - 1) / RB;
    const int pairs = (N + NR - 1) / NR;
    const long long slots = static_cast<long long>(per_sm) * sms();   // resident blocks
    // few row pairs: split K over kw warps until about FILL_WARPS_PER_SM
    // warps an SM have work, keeping a step a warp; else one wave of blocks
    // walking the pairs
    int kw = 1;
    const long long fill = static_cast<long long>(FILL_WARPS_PER_SM) * sms();
    while (kw < WARPS && 2 * kw <= steps && static_cast<long long>(pairs) * gy * kw < fill) kw *= 2;
    int gx = (pairs + WARPS / kw - 1) / (WARPS / kw);
    if (kw == 1) gx = static_cast<int>(std::min<long long>(gx, std::max<long long>(1, slots / gy)));
    kern<<<dim3(gx, gy), WARPS * 32, dyn, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
        static_cast<__nv_bfloat16*>(y), B, N, K, kw);
    return static_cast<int>(cudaGetLastError());
}

// x staged in shared memory where its RB rows fit XS_MAX_BYTES (every
// decode step, B = 1, at the 8B shapes), read from global memory otherwise
template <class Dec, int RB, bool A16>
int launch_rb(const void* x, const void* w, void* y, int B, int N, int K, cudaStream_t s) {
    if (xs_bytes<RB>(K) <= XS_MAX_BYTES) return launch_k<Dec, RB, A16, true>(x, w, y, B, N, K, s);
    return launch_k<Dec, RB, A16, false>(x, w, y, B, N, K, s);
}

template <class Dec, bool A16>
int launch_a(const void* x, const void* w, void* y, int B, int N, int K, cudaStream_t s) {
    if (B == 1) return launch_rb<Dec, 1, A16>(x, w, y, B, N, K, s);
    if (B == 2) return launch_rb<Dec, 2, A16>(x, w, y, B, N, K, s);
    if (B <= 4) return launch_rb<Dec, 4, A16>(x, w, y, B, N, K, s);
    return launch_rb<Dec, 8, A16>(x, w, y, B, N, K, s);
}

// The decode path for any whole-block shape: 16-byte loads where W's base
// and row stride and x's base allow them, the decoder's narrow loads
// otherwise.
template <class Dec>
int launch(const void* x, const void* w, void* y, int B, int N, int K, cudaStream_t s) {
    const size_t row_bytes = static_cast<size_t>(K / Dec::ELEMS) * Dec::BYTES;
    if (reinterpret_cast<uintptr_t>(w) % 16 == 0 && row_bytes % 16 == 0 &&
        reinterpret_cast<uintptr_t>(x) % 16 == 0)
        return launch_a<Dec, true>(x, w, y, B, N, K, s);
    return launch_a<Dec, false>(x, w, y, B, N, K, s);
}

}  // namespace qgemv
}  // namespace lfkt
