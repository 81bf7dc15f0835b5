// Layer-looped decode: K whole transformer layers of one decode token in ONE
// launch.  For each layer l of [layer0, layer0 + K):
//   hn = rms_norm(h, attn_norm)                       (f32 -> bf16)
//   q, k, v = hn Wq^T, hn Wk^T, hn Wv^T               (-> bf16)
//   q, k = rope(q), rope(k) at `pos`                  (f32 -> bf16)
//   ring[l][:, pos] = k, v                            (bf16, or int8 + f32 scale)
//   ctx = softmax(q K^T * hd^-0.5 [* k_s]) [* v_s] V  (f32 scores and softmax,
//                                                      probabilities -> bf16,
//                                                      P.V in f32 -> bf16)
//   h = h + ctx Wo^T                                  (bf16)
//   hn = rms_norm(h, ffn_norm)
//   h = h + (silu(hn Wg^T) * (hn Wu^T)) Wd^T          (silu in f32 -> bf16)
// with every linear either bf16 {"w"} (f32 accumulation) or int8 {"q","s"}
// (the activation quantized per row to int8, an exact int32 dot by __dp4a,
// then (acc * xs) * s in f32).  Templated on the weight kind and on the KV
// ring (bf16, or int8 with per-token f32 scales): four instantiations, the
// reference's four loop geometries.
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/decode_loop.py::_loop_kernel
// (launched by decode_loop_step, :306).  The TPU kernel walks a sequential
// grid over the K layers and carries h in VMEM scratch.  Hopper's blocks run
// in parallel and in no order, so this is one persistent, cooperatively
// launched grid (every block resident: cudaLaunchCooperativeKernel refuses a
// grid larger than the card holds) that walks the layers itself, with a
// grid-wide barrier between the phases of a layer:
//   P1  norm + q/k/v rows            (a warp per weight row, all blocks)
//   P2  RoPE of k + the ring write   (a warp per KV head row of k or v)
//   P3  decode attention             (a block per query head)
//   P4  wo rows + residual           (a warp per row)
//   P5  norm + gate/up rows + SiLU*up (a warp per FFN row pair)
//   P6  down rows + residual         (a warp per row)
// The new K/V slot is written in P2 and read in P3, after a barrier.  Each
// block recomputes the row-wide reductions it needs (the rms of h, the int8
// activation max over 4096 or 14336 values) from global memory after a
// barrier instead of waiting for one block to broadcast them.  h, the raw
// q/k/v, ctx and the FFN intermediate live in scratch the wrapper allocates;
// the weights are per-layer tensors reached through a device table of
// pointers (16 a layer), so nothing is restacked.  The barrier is a counter
// in global memory whose top bit flips when every block has arrived (the
// scheme of cooperative_groups' grid sync), so no relocatable device code
// (-rdc) is needed.  Data written inside the launch is read with __ldcg (L2,
// never a stale L1 line); only the weights go through the read-only path.
//
// Bound on the H100: bytes — the weights of the K layers, read once: 436 MB a
// layer in bf16 (4096x4096 x2, 1024x4096 x2, 14336x4096 x3) and 218 MB in
// int8 (+ 113 KB of scales), i.e. 4.2 / 2.1 ms for a 32-layer token at
// 3.35 TB/s; the ring read at pos <= 1023 is under 0.2 MB a layer.  A decode
// token does ~2 FLOP a weight byte (bf16) — far below the card's ~295 ops a
// byte.  Design for the bytes: 16-byte weight loads, consecutive lanes on
// consecutive addresses, four loads in flight a lane, every warp of the grid
// streaming rows.  What the barriers cost (six a layer) and what the
// per-head attention phase leaves idle is measured by chip_smoke.py.
//
// Arithmetic: the reference's per-layer source (decode_loop.py:182-233)
// step by step.  The int8 activation quantize and the KV ring quantize are
// bit-exact with the plain versions (IEEE-rounded divisions, rintf); the
// dot products and the rms and softmax reductions sum in another order than
// the plain path, so the layer output agrees within a tolerance.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// blocks a multiprocessor runs, at most (the occupancy query may allow fewer)
constexpr int BLOCKS_PER_SM = 2;

// the 16 pointers of one layer in the weight table
enum : int {
    T_WQ = 0, T_WK, T_WV, T_WO, T_WG, T_WU, T_WD,       // weight rows (bf16 or int8)
    T_SQ, T_SK, T_SV, T_SO, T_SG, T_SU, T_SD,           // int8 row scales (f32)
    T_ATTN_NORM, T_FFN_NORM,                            // f32 norm weights
    TABLE
};

struct LoopArgs {
    const unsigned long long* table;   // (n_layers_total, TABLE) device pointers
    __nv_bfloat16* h;                  // (dim) residual, in and out
    void* kc;                          // ring K of layer 0: bf16 or int8 (L, n_kv, n_ctx, hd)
    void* vc;                          // ring V, the same layout
    float* ks;                         // int8 ring scales (L, n_kv, n_ctx); null for bf16
    float* vs;
    __nv_bfloat16* qkv;                // scratch (dim + 2 * n_kv * hd): raw q | k | v
    __nv_bfloat16* ctx;                // scratch (dim)
    __nv_bfloat16* act;                // scratch (ffn)
    const float* cos_t;                // (hd / 2) at pos
    const float* sin_t;
    unsigned int* bar;                 // the barrier counter (zero before the first launch)
    int layer0, n_layers, dim, ffn, n_heads, n_kv, hd, n_ctx, pos, window;
    float eps, sm_scale;
};

__device__ __forceinline__ float bf(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf(float x) { return bf(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float ld_bf(const __nv_bfloat16* p) { return bf(__ldcg(p)); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return bf(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

// bf16 pair (low, high) of a 32-bit word as floats
__device__ __forceinline__ float lo_bf(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// Grid-wide barrier over a cooperative launch.  Block 0 adds 2^31 - (n - 1)
// and every other block 1, so the word's top bit flips exactly when the last
// block arrives and its low bits return to where they were.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned int n = gridDim.x;
        const unsigned int inc = blockIdx.x == 0 ? 0x80000000u - (n - 1) : 1u;
        __threadfence();
        const unsigned int old = atomicAdd(bar, inc);
        volatile unsigned int* v = bar;
        while (((old ^ *v) & 0x80000000u) == 0) {
        }
        __threadfence();
    }
    __syncthreads();
}

// block-wide sum / max, the result in every thread (`red`: WARPS floats)
__device__ __forceinline__ float block_sum(float v, float* red) {
    v = lfkt::warp_sum(v);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += red[w];
    return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
    v = lfkt::warp_max(v);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float t = red[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) t = fmaxf(t, red[w]);
    return t;
}

// The activation of a linear, staged in shared memory: `xb` (n bf16) and,
// for int8 weights, its per-row int8 quantization `xq` with scale *xs:
// xs = max|x| / 127 (1 for an all-zero row), xq = round_half_even(x / xs).
template <bool W8>
__device__ __forceinline__ void quantize_staged(const __nv_bfloat16* xb, int n, int8_t* xq,
                                                float* xs, float* red) {
    if constexpr (!W8) return;
    float m = 0.f;
    for (int i = threadIdx.x; i < n; i += THREADS) m = fmaxf(m, fabsf(bf(xb[i])));
    m = block_max(m, red);
    const float s = m > 0.f ? __fdiv_rn(m, 127.0f) : 1.0f;
    for (int i = threadIdx.x; i < n; i += THREADS)
        xq[i] = static_cast<int8_t>(rintf(__fdiv_rn(bf(xb[i]), s)));
    if (threadIdx.x == 0) *xs = s;
    __syncthreads();
}

// xb = bf16((x * rsqrt(mean(x^2) + eps)) * w) for x = h
template <bool W8>
__device__ void stage_norm(const __nv_bfloat16* h, const float* w, int n, float eps,
                           __nv_bfloat16* xb, int8_t* xq, float* xs, float* red) {
    float ss = 0.f;
    for (int i = threadIdx.x; i < n; i += THREADS) {
        const float x = ld_bf(h + i);
        ss += __fmul_rn(x, x);
    }
    ss = block_sum(ss, red);
    const float inv = rsqrtf(__fdiv_rn(ss, static_cast<float>(n)) + eps);
    for (int i = threadIdx.x; i < n; i += THREADS)
        xb[i] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(ld_bf(h + i), inv), __ldg(w + i)));
    __syncthreads();
    quantize_staged<W8>(xb, n, xq, xs, red);
}

// xb = a vector written earlier in this launch (ctx, act)
template <bool W8>
__device__ void stage_copy(const __nv_bfloat16* src, int n, __nv_bfloat16* xb, int8_t* xq,
                           float* xs, float* red) {
    for (int i = threadIdx.x; i < n; i += THREADS) xb[i] = __ldcg(src + i);
    __syncthreads();
    quantize_staged<W8>(xb, n, xq, xs, red);
}

// One output of a linear, by one warp: row `row` of the weight (K inputs)
// against the staged activation.  Returns the f32 value before its bf16
// rounding; K % 16 == 0 and every row 16-byte aligned (the launcher checks).
template <bool W8>
__device__ __forceinline__ float linear_row(const void* wp, const void* sp, int row, int K,
                                            const __nv_bfloat16* xb, const int8_t* xq, float xs,
                                            int lane) {
    if constexpr (W8) {
        const int8_t* w = static_cast<const int8_t*>(wp) + static_cast<size_t>(row) * K;
        int acc = 0;
#pragma unroll 4
        for (int k = lane * 16; k < K; k += 32 * 16) {
            const int4 a = __ldg(reinterpret_cast<const int4*>(w + k));
            const int4 b = *reinterpret_cast<const int4*>(xq + k);
            acc = __dp4a(a.x, b.x, acc);
            acc = __dp4a(a.y, b.y, acc);
            acc = __dp4a(a.z, b.z, acc);
            acc = __dp4a(a.w, b.w, acc);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        const float s = __ldg(static_cast<const float*>(sp) + row);
        return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), s);
    } else {
        const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wp) + static_cast<size_t>(row) * K;
        float acc = 0.f;
#pragma unroll 4
        for (int k = lane * 8; k < K; k += 32 * 8) {
            const uint4 a = __ldg(reinterpret_cast<const uint4*>(w + k));
            const uint4 b = *reinterpret_cast<const uint4*>(xb + k);
            acc = fmaf(lo_bf(a.x), lo_bf(b.x), acc);
            acc = fmaf(hi_bf(a.x), hi_bf(b.x), acc);
            acc = fmaf(lo_bf(a.y), lo_bf(b.y), acc);
            acc = fmaf(hi_bf(a.y), hi_bf(b.y), acc);
            acc = fmaf(lo_bf(a.z), lo_bf(b.z), acc);
            acc = fmaf(hi_bf(a.z), hi_bf(b.z), acc);
            acc = fmaf(lo_bf(a.w), lo_bf(b.w), acc);
            acc = fmaf(hi_bf(a.w), hi_bf(b.w), acc);
        }
        return lfkt::warp_sum(acc);
    }
}

// the interleaved RoPE of pair i of a head row: (x1, x2) -> bf16 (o1, o2)
__device__ __forceinline__ void rope_pair(float x1, float x2, float c, float s, float& o1,
                                          float& o2) {
    o1 = round_bf(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    o2 = round_bf(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
}

template <bool W8, bool KV8>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) decode_loop_kernel(const LoopArgs a) {
    using KT = typename std::conditional<KV8, int8_t, __nv_bfloat16>::type;
    extern __shared__ __align__(16) unsigned char smem[];
    const int maxk = ((a.dim > a.ffn ? a.dim : a.ffn) + 15) & ~15;
    __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(smem);                 // maxk
    int8_t* xq = reinterpret_cast<int8_t*>(xb + maxk);                          // maxk
    float* sc = reinterpret_cast<float*>(xq + maxk);                            // n_ctx
    float* qf = sc + a.n_ctx;                                                   // hd
    float* pv = qf + a.hd;                                                      // THREADS
    float* red = pv + THREADS;                                                  // WARPS
    float* xs = red + WARPS;                                                    // 1

    const int lane = threadIdx.x & 31;
    const int gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int nwarps = gridDim.x * WARPS;
    const int dim = a.dim, ffn = a.ffn, hd = a.hd, n_kv = a.n_kv, n_ctx = a.n_ctx, pos = a.pos;
    const int kvd = n_kv * hd;
    const int group = a.n_heads / n_kv;
    const size_t ring_layer = static_cast<size_t>(n_kv) * n_ctx * hd;
    const int lo = a.window > 0 ? max(0, pos - a.window + 1) : 0;

    for (int l = 0; l < a.n_layers; ++l) {
        const int layer = a.layer0 + l;
        const unsigned long long* tab = a.table + static_cast<size_t>(layer) * TABLE;
        auto ptr = [&](int i) { return reinterpret_cast<const void*>(__ldg(tab + i)); };
        KT* kring = static_cast<KT*>(a.kc) + layer * ring_layer;
        KT* vring = static_cast<KT*>(a.vc) + layer * ring_layer;
        float* kscale = KV8 ? a.ks + static_cast<size_t>(layer) * n_kv * n_ctx : nullptr;
        float* vscale = KV8 ? a.vs + static_cast<size_t>(layer) * n_kv * n_ctx : nullptr;

        // P1: hn = rms_norm(h); raw q | k | v rows
        stage_norm<W8>(a.h, static_cast<const float*>(ptr(T_ATTN_NORM)), dim, a.eps, xb, xq, xs,
                       red);
        for (int r = gwarp; r < dim + 2 * kvd; r += nwarps) {
            const int which = r < dim ? 0 : (r < dim + kvd ? 1 : 2);
            const int row = which == 0 ? r : r - dim - (which - 1) * kvd;
            const float y = linear_row<W8>(ptr(T_WQ + which), ptr(T_SQ + which), row, dim, xb, xq,
                                           *xs, lane);
            if (lane == 0) a.qkv[r] = __float2bfloat16_rn(y);
        }
        grid_sync(a.bar);

        // P2: k after RoPE and v into the ring slot at pos (one warp a head row)
        for (int u = gwarp; u < 2 * n_kv; u += nwarps) {
            const bool is_v = u >= n_kv;
            const int j = is_v ? u - n_kv : u;
            const __nv_bfloat16* src = a.qkv + dim + (is_v ? kvd : 0) + j * hd;
            float x[8];                          // this lane's pairs i = lane + 32 p
            float amax = 0.f;
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                const int i = lane + 32 * p;
                if (2 * i < hd) {
                    float x1 = ld_bf(src + 2 * i), x2 = ld_bf(src + 2 * i + 1);
                    if (!is_v) rope_pair(x1, x2, __ldg(a.cos_t + i), __ldg(a.sin_t + i), x1, x2);
                    x[2 * p] = x1;
                    x[2 * p + 1] = x2;
                    amax = fmaxf(amax, fmaxf(fabsf(x1), fabsf(x2)));
                }
            }
            const size_t slot = static_cast<size_t>(j) * n_ctx + pos;
            KT* dst = (is_v ? vring : kring) + slot * hd;
            if constexpr (KV8) {
                float inv;
                const float s = lfkt::kv_row_scale(amax, inv);
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    const int i = lane + 32 * p;
                    if (2 * i < hd) {
                        reinterpret_cast<int8_t*>(dst)[2 * i] = lfkt::kv_quantize_value(x[2 * p], inv);
                        reinterpret_cast<int8_t*>(dst)[2 * i + 1] =
                            lfkt::kv_quantize_value(x[2 * p + 1], inv);
                    }
                }
                if (lane == 0) (is_v ? vscale : kscale)[slot] = s;
            } else {
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    const int i = lane + 32 * p;
                    if (2 * i < hd) {
                        reinterpret_cast<__nv_bfloat16*>(dst)[2 * i] = __float2bfloat16_rn(x[2 * p]);
                        reinterpret_cast<__nv_bfloat16*>(dst)[2 * i + 1] =
                            __float2bfloat16_rn(x[2 * p + 1]);
                    }
                }
            }
        }
        grid_sync(a.bar);

        // P3: attention of each query head over ring slots [lo, pos]
        for (int hq = blockIdx.x; hq < a.n_heads; hq += gridDim.x) {
            const int j = hq / group;
            for (int i = threadIdx.x; 2 * i < hd; i += THREADS) {
                float o1, o2;
                rope_pair(ld_bf(a.qkv + hq * hd + 2 * i), ld_bf(a.qkv + hq * hd + 2 * i + 1),
                          __ldg(a.cos_t + i), __ldg(a.sin_t + i), o1, o2);
                qf[2 * i] = o1;
                qf[2 * i + 1] = o2;
            }
            __syncthreads();
            const KT* kh = kring + static_cast<size_t>(j) * n_ctx * hd;
            const KT* vh = vring + static_cast<size_t>(j) * n_ctx * hd;
            float m = -INFINITY;
            for (int c = lo + threadIdx.x; c <= pos; c += THREADS) {
                float acc = 0.f;
                const KT* kr = kh + static_cast<size_t>(c) * hd;
                if constexpr (KV8) {
                    for (int d = 0; d < hd; d += 16) {
                        const int4 w = __ldcg(reinterpret_cast<const int4*>(kr + d));
                        const int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                        for (int e = 0; e < 16; ++e)
                            acc = fmaf(qf[d + e],
                                       static_cast<float>(static_cast<int8_t>(ws[e >> 2] >> (8 * (e & 3)))),
                                       acc);
                    }
                } else {
                    for (int d = 0; d < hd; d += 8) {
                        const uint4 w = __ldcg(reinterpret_cast<const uint4*>(kr + d));
                        acc = fmaf(qf[d + 0], lo_bf(w.x), acc);
                        acc = fmaf(qf[d + 1], hi_bf(w.x), acc);
                        acc = fmaf(qf[d + 2], lo_bf(w.y), acc);
                        acc = fmaf(qf[d + 3], hi_bf(w.y), acc);
                        acc = fmaf(qf[d + 4], lo_bf(w.z), acc);
                        acc = fmaf(qf[d + 5], hi_bf(w.z), acc);
                        acc = fmaf(qf[d + 6], lo_bf(w.w), acc);
                        acc = fmaf(qf[d + 7], hi_bf(w.w), acc);
                    }
                }
                float s = __fmul_rn(acc, a.sm_scale);
                if constexpr (KV8) s = __fmul_rn(s, __ldcg(kscale + static_cast<size_t>(j) * n_ctx + c));
                sc[c - lo] = s;
                m = fmaxf(m, s);
            }
            m = block_max(m, red);
            float sum = 0.f;
            for (int c = lo + threadIdx.x; c <= pos; c += THREADS) {
                const float e = expf(sc[c - lo] - m);
                sc[c - lo] = e;
                sum += e;
            }
            sum = block_sum(sum, red);
            for (int c = lo + threadIdx.x; c <= pos; c += THREADS) {
                float p = __fdiv_rn(sc[c - lo], sum);
                if constexpr (KV8) p = __fmul_rn(p, __ldcg(vscale + static_cast<size_t>(j) * n_ctx + c));
                sc[c - lo] = round_bf(p);       // probabilities rounded to bf16
            }
            __syncthreads();
            const int d = threadIdx.x % hd, g = threadIdx.x / hd, G = THREADS / hd;
            float acc = 0.f;
            for (int c = lo + g; c <= pos; c += G) {
                acc = fmaf(sc[c - lo], to_f(__ldcg(vh + static_cast<size_t>(c) * hd + d)), acc);
            }
            pv[threadIdx.x] = acc;
            __syncthreads();
            if (threadIdx.x < hd) {
                float t = 0.f;
                for (int gg = 0; gg < G; ++gg) t += pv[gg * hd + threadIdx.x];
                a.ctx[hq * hd + threadIdx.x] = __float2bfloat16_rn(t);
            }
            __syncthreads();
        }
        grid_sync(a.bar);

        // P4: h += ctx Wo^T
        stage_copy<W8>(a.ctx, dim, xb, xq, xs, red);
        for (int r = gwarp; r < dim; r += nwarps) {
            const float y = linear_row<W8>(ptr(T_WO), ptr(T_SO), r, dim, xb, xq, *xs, lane);
            if (lane == 0) a.h[r] = __float2bfloat16_rn(ld_bf(a.h + r) + round_bf(y));
        }
        grid_sync(a.bar);

        // P5: hn = rms_norm(h); act = bf16(silu(gate)) * up
        stage_norm<W8>(a.h, static_cast<const float*>(ptr(T_FFN_NORM)), dim, a.eps, xb, xq, xs,
                       red);
        for (int r = gwarp; r < ffn; r += nwarps) {
            const float g = round_bf(linear_row<W8>(ptr(T_WG), ptr(T_SG), r, dim, xb, xq, *xs, lane));
            const float u = round_bf(linear_row<W8>(ptr(T_WU), ptr(T_SU), r, dim, xb, xq, *xs, lane));
            if (lane == 0) {
                const float sg = round_bf(__fdiv_rn(g, 1.0f + expf(-g)));
                a.act[r] = __float2bfloat16_rn(__fmul_rn(sg, u));
            }
        }
        grid_sync(a.bar);

        // P6: h += act Wd^T
        stage_copy<W8>(a.act, ffn, xb, xq, xs, red);
        for (int r = gwarp; r < dim; r += nwarps) {
            const float y = linear_row<W8>(ptr(T_WD), ptr(T_SD), r, ffn, xb, xq, *xs, lane);
            if (lane == 0) a.h[r] = __float2bfloat16_rn(ld_bf(a.h + r) + round_bf(y));
        }
        if (l + 1 < a.n_layers) grid_sync(a.bar);
    }
}

size_t smem_bytes(int dim, int ffn, int n_ctx, int hd) {
    const size_t maxk = static_cast<size_t>(((dim > ffn ? dim : ffn) + 15) & ~15);
    return maxk * 3 + sizeof(float) * (static_cast<size_t>(n_ctx) + hd + THREADS + WARPS + 1);
}

template <bool W8, bool KV8>
int launch(const LoopArgs& a, cudaStream_t stream) {
    const void* kern = reinterpret_cast<const void*>(decode_loop_kernel<W8, KV8>);
    const size_t smem = smem_bytes(a.dim, a.ffn, a.n_ctx, a.hd);
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return static_cast<int>(e);
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem)) !=
        cudaSuccess)
        return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const dim3 grid((per_sm < BLOCKS_PER_SM ? per_sm : BLOCKS_PER_SM) * sms);
    LoopArgs args = a;
    void* kargs[] = {&args};
    e = cudaLaunchCooperativeKernel(kern, grid, dim3(THREADS), kargs, smem, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

LFKT_API int lfkt_decode_loop(const void* table, void* h, void* kc, void* vc, void* ks, void* vs,
                              void* qkv, void* ctx, void* act, const void* cos_t,
                              const void* sin_t, void* bar, int layer0, int n_layers, int dim,
                              int ffn, int n_heads, int n_kv, int hd, int n_ctx, int pos,
                              int window, float eps, float sm_scale, int w_int8, int kv_int8,
                              void* stream) {
    if (n_layers <= 0) return 0;
    if ((hd != 32 && hd != 64 && hd != 128 && hd != 256) || n_heads * hd != dim || n_kv <= 0 ||
        n_heads % n_kv || dim % 16 || ffn % 16 || ffn <= 0 || pos < 0 || pos >= n_ctx ||
        layer0 < 0 || (kv_int8 && (ks == nullptr || vs == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    LoopArgs a{static_cast<const unsigned long long*>(table), static_cast<__nv_bfloat16*>(h), kc,
               vc, static_cast<float*>(ks), static_cast<float*>(vs),
               static_cast<__nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(ctx),
               static_cast<__nv_bfloat16*>(act), static_cast<const float*>(cos_t),
               static_cast<const float*>(sin_t), static_cast<unsigned int*>(bar), layer0,
               n_layers, dim, ffn, n_heads, n_kv, hd, n_ctx, pos, window, eps, sm_scale};
    auto s = static_cast<cudaStream_t>(stream);
    if (w_int8) return kv_int8 ? launch<true, true>(a, s) : launch<true, false>(a, s);
    return kv_int8 ? launch<false, true>(a, s) : launch<false, false>(a, s);
}
