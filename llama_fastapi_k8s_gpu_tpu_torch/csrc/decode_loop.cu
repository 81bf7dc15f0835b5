// Layer-looped decode: K whole transformer layers of one decode token in ONE
// launch.  For each layer l of [layer0, layer0 + K):
//   hn = rms_norm(h, attn_norm)                       (f32 -> bf16)
//   q, k, v = hn Wq^T, hn Wk^T, hn Wv^T               (-> bf16)
//   q, k = rope(q), rope(k) at `pos`                  (f32 -> bf16)
//          (`pos`: the token's ring slot, read from device memory at entry)
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
//   P1  norm + q/k/v rows                 (a warp per two weight rows)
//   P2  attention, with the new K/V slot  (a block per KV head x key chunk)
//   P3  wo rows + residual                (a warp per two rows)
//   P4  norm + gate/up rows + SiLU*up     (a warp per gate/up row pair)
//   P5  down rows + residual              (a warp per two rows)
// Five barriers a layer, four after the last.  Each block recomputes the
// row-wide reductions it needs (the rms of h, the int8 activation max over
// 4096 or 14336 values) from global memory after a barrier instead of
// waiting for one block to broadcast them.  h, the raw q/k/v, ctx and the
// FFN intermediate live in scratch the wrapper allocates; the weights are
// per-layer tensors reached through a device table of pointers (16 a layer),
// so nothing is restacked.  The barrier is a counter in global memory whose
// top bit flips when every block has arrived (the scheme of
// cooperative_groups' grid sync), arrived at with a release-acquire atomic
// and polled with acquire loads, so no relocatable device code (-rdc) and
// no full fence is needed.  Data written inside the launch is read with
// __ldcg (L2, never a stale L1 line); only the weights go through the
// read-only path.
//
// P2 is split-K attention over the whole grid (flash-decoding).  A work item
// is KV head j and one chunk of C ring slots — chunks aligned to multiples
// of C, clipped to the keys [lo, pos] — and serves all `group` query heads
// of j, so each K and V row is read once a layer.  C is the smallest power
// of two in [CHUNK_MIN, CHUNK_MAX] that gives at most one item a block (the
// 8B on 264 blocks: 32 slots at slots 700 and 1023, 176 and 256 items);
// past that, blocks take several items.  Two steps, with no grid barrier
// between them:
//   1. every item of the block copies its K and V rows into shared memory
//      with 16-byte cp.async (consecutive threads on consecutive 16 bytes
//      of a row, all in flight at once) and ropes its query rows; the item
//      whose chunk holds `pos` also ropes k, writes slot pos of head j into
//      the ring (bf16, or int8 + scale) and stages those values for itself,
//      so the new slot needs no barrier of its own.  It computes the
//      chunk's scores s, its max m and l = sum exp(s - m) per query head,
//      keeps them in scratch and arrives on head j's first counter;
//   2. once the counter shows every chunk of head j (a spin of thread 0;
//      every block finished step 1 before it waits, so the wait ends), an
//      item takes the head's M = max m and L = sum l exp(m - M), rounds
//      p = bf16(exp(s - M) / L [* v_s]) — the plain path's probabilities,
//      rounded where it rounds them — and writes the chunk's P.V; the last
//      item of head j on the second counter sums the chunks into ctx (bf16)
//      and returns both counters to zero.
// A block does its items' step 2 newest first, so its last item finds its
// rows and scores still staged; an earlier one copies its V rows and reads
// its scores again.  Shared memory does not grow with n_ctx;
// ops/decode_loop.py::split_attention_plain is this decomposition in plain
// PyTorch.
//
// Bound on the H100: bytes — the weights of the K layers, read once: 436 MB a
// layer in bf16 (4096x4096 x2, 1024x4096 x2, 14336x4096 x3) and 218 MB in
// int8 (+ 113 KB of scales), i.e. 4.2 / 2.1 ms for a 32-layer token at
// 3.35 TB/s; the ring read is at most 4.2 MB a layer (bf16 ring, slot 1023),
// 1% of the bf16 weights.  A decode token does ~2 FLOP a weight byte (bf16)
// — far below the card's ~295 ops a byte.  Design for the bytes: 16-byte
// weight loads, consecutive lanes on consecutive addresses, every warp of
// the grid streaming two rows at once (their loads interleaved, four of
// each in flight a lane), the activation staged with 16-byte loads.
//
// Over a tensor-parallel mesh (every shard on the launching card) one launch
// still runs the whole layer stack, reading each layer from its tp shards:
// the table holds tp rows of 16 pointers a layer, and each linear is laid
// out one of three ways (LoopArgs::modes, parallel/mesh.py's rules):
//   col  output row r lives in shard r / (N/tp), at local row r % (N/tp);
//   row  input column c lives in shard c / (K/tp), at local column c % (K/tp)
//        (wo, w_down only); a warp walks the K segments shard by shard in
//        the one-shard column order, so the dot is summed as one card sums
//        it and rounded once; an int8 row keeps its whole scale on shard 0;
//   rep  shard 0 holds the whole weight.
// The norms are read from shard 0.  The ring's KV heads are split over the
// shards (head j in shard j / (n_kv/tp)) or, where tp does not divide them,
// replicated: the new slot is written to every shard and read from shard 0.
// At tp = 1 this is the one-card table and launch.
//
// Arithmetic: the reference's per-layer source (decode_loop.py:182-233)
// step by step.  The int8 activation quantize and the KV ring quantize are
// bit-exact with the plain versions (IEEE-rounded divisions, rintf; see
// act_code); the dot products, the rms and the attention sums run in
// another order than the plain path, so the layer output agrees within a
// tolerance.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// blocks a multiprocessor runs, at most (the occupancy query may allow fewer)
constexpr int BLOCKS_PER_SM = 2;
// the key chunk of an attention item: a power of two in [CHUNK_MIN,
// CHUNK_MAX] (ops/decode_loop.py sizes the partials for CHUNK_MIN)
constexpr int CHUNK_MIN = 8;
constexpr int CHUNK_MAX = 64;
// tp shards a launch reads, at most
constexpr int MAX_TP = 8;

// the 16 pointers of one layer's shard in the weight table
enum : int {
    T_WQ = 0, T_WK, T_WV, T_WO, T_WG, T_WU, T_WD,       // weight rows (bf16 or int8)
    T_SQ, T_SK, T_SV, T_SO, T_SG, T_SU, T_SD,           // int8 row scales (f32)
    T_ATTN_NORM, T_FFN_NORM,                            // f32 norm weights
    TABLE
};
// the seven linears, in table order
constexpr int LINEARS = T_SQ;

// how a linear lies over the tp shards: 2 bits a linear in LoopArgs::modes
enum : int { M_REP = 0, M_COL = 1, M_ROW = 2 };

struct LoopArgs {
    const unsigned long long* table;   // (n_layers_total, tp, TABLE) device pointers
    __nv_bfloat16* h;                  // (dim) residual, in and out
    void* rk[MAX_TP];                  // each shard's ring K of layer 0: bf16 or int8
                                       // (L, n_kv_local, n_ctx, hd)
    void* rv[MAX_TP];                  // ring V, the same layout
    float* rks[MAX_TP];                // int8 ring scales (L, n_kv_local, n_ctx); null for bf16
    float* rvs[MAX_TP];
    __nv_bfloat16* qkv;              // scratch (dim + 2 * n_kv * hd): raw q | k | v
    __nv_bfloat16* ctx;                // scratch (dim)
    __nv_bfloat16* act;                // scratch (ffn)
    const float* cos_t;                // (hd / 2) at pos
    const float* sin_t;
    const long long* positions;        // (1) the token's ring slot `pos`, read at entry
    unsigned int* bar;                 // the barrier counter (zero before the first launch)
    float* part;                       // attention partials: (n_heads, max_chunks, hd) sums
                                       // of P.V, (n_heads, max_chunks, 2) of (m, l), then
                                       // (n_heads, n_ctx) scores
    unsigned int* cnt;                 // (2, n_kv) arrivals per KV head (zero between launches)
    int layer0, n_layers, dim, ffn, n_heads, n_kv, hd, n_ctx, window, max_chunks;
    int tp;                            // shards a layer and a ring have
    int modes;                         // M_* of linear w at bits 2w, 2w + 1
    int kv_split;                      // the ring's heads split over tp (else replicated)
    int n_kv_local;                    // heads a ring shard holds
    float eps, sm_scale;
};

// Where row r of linear w (n_out rows of k_in inputs) lies: its shard `sh`
// and local row `row`, its inputs in `nseg` segments of `kt` columns,
// segment s in shard sh + s.
__device__ __forceinline__ void locate(const LoopArgs& a, int w, int r, int n_out, int k_in,
                                       int& sh, int& row, int& nseg, int& kt) {
    const int m = (a.modes >> (2 * w)) & 3;
    sh = 0;
    row = r;
    nseg = 1;
    kt = k_in;
    if (m == M_COL) {
        const int nt = n_out / a.tp;
        sh = r / nt;
        row = r - sh * nt;
    } else if (m == M_ROW) {
        nseg = a.tp;
        kt = k_in / a.tp;
    }
}

// the shard that holds KV head j for reading, and j's index there
__device__ __forceinline__ void head_at(const LoopArgs& a, int j, int& t, int& jl) {
    t = a.kv_split ? j / a.n_kv_local : 0;
    jl = j - t * a.n_kv_local * a.kv_split;
}

// The attention phase's shared memory, laid over the linears' staging area:
// byte offsets for `group` query heads of hd and ring rows of rb bytes.
struct AttnSmem {
    int q, k, v, ks, vs, sc, ml, bytes;
    __host__ __device__ AttnSmem(int group, int hd, int rb) {
        q = 0;                                 // group x (hd + 4) f32: q after RoPE
        k = q + group * (hd + 4) * 4;          // CHUNK_MAX ring rows of K, rb + 16 apart
        v = k + CHUNK_MAX * (rb + 16);         // CHUNK_MAX ring rows of V
        ks = v + CHUNK_MAX * rb;               // CHUNK_MAX f32 K scales (int8 ring)
        vs = ks + CHUNK_MAX * 4;               // ... V scales
        sc = vs + CHUNK_MAX * 4;               // group x CHUNK_MAX f32 scores -> probabilities
        ml = sc + group * CHUNK_MAX * 4;       // group x (M, L) of the combine
        bytes = ml + ((group * 8 + 15) & ~15);
    }
};

// bytes of shared memory before the block's reduction slots: the linears'
// staging (xb and xq: 3 bytes an input) or the attention's, the larger
__host__ __device__ __forceinline__ int region_bytes(int dim, int ffn, int group, int hd,
                                                     int rb) {
    const int maxk = ((dim > ffn ? dim : ffn) + 15) & ~15;
    const int attn = AttnSmem(group, hd, rb).bytes;
    return 3 * maxk > attn ? 3 * maxk : attn;
}

__device__ __forceinline__ float bf(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf(float x) { return bf(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float ld_bf(const __nv_bfloat16* p) { return bf(__ldcg(p)); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return bf(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

using lfkt::hi_bf;
using lfkt::lo_bf;

// 16 bytes global -> shared, asynchronously (L2 only), and the wait for all
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// GPU-scope arrivals and polls: *p += v returning the old value with
// acquire-release order, *p += v with release order, an acquire load
__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
    unsigned old;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], %2;\n"
                 : "=r"(old) : "l"(p), "r"(v) : "memory");
    return old;
}

__device__ __forceinline__ void red_add_release(unsigned* p, unsigned v) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// Grid-wide barrier over a cooperative launch.  Block 0 adds 2^31 - (n - 1)
// and every other block 1, so the word's top bit flips exactly when the last
// block arrives and its low bits return to where they were.  The arrival
// releases what the block wrote (every thread's writes are ordered before
// it by __syncthreads) and the polls acquire what the others wrote.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
    __syncthreads();
    if (threadIdx.x == 0) {
        const unsigned int n = gridDim.x;
        const unsigned int inc = blockIdx.x == 0 ? 0x80000000u - (n - 1) : 1u;
        const unsigned int old = atom_add_acq_rel(bar, inc);
        while (((old ^ ld_acquire(bar)) & 0x80000000u) == 0) {
        }
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

// rint(x / s) as int8, bit-exact, from y = x * inv (inv = 1 / s rounded):
// |x / s| <= 127 (1 + 2^-24), so y is within 2e-5 of x / s and fl(x / s)
// within 4e-6; where y lies farther than 1e-4 from a half-integer both round
// to the same integer.  Nearer (or for a non-finite y) the IEEE division
// decides, as the plain version divides.
__device__ __forceinline__ int8_t act_code(float x, float s, float inv) {
    const float y = __fmul_rn(x, inv);
    const float r = rintf(y);
    if (fabsf(fabsf(y - r) - 0.5f) > 1e-4f) return static_cast<int8_t>(r);
    return static_cast<int8_t>(rintf(__fdiv_rn(x, s)));
}

// The activation of a linear, staged in shared memory: `xb` (n bf16) and,
// for int8 weights, its per-row int8 quantization `xq` with scale *xs:
// xs = max|x| / 127 (1 for an all-zero row), xq = round_half_even(x / xs).
// n % 16 == 0; a thread takes 8 values at a time.
template <bool W8>
__device__ __forceinline__ void quantize_staged(const __nv_bfloat16* xb, int n, int8_t* xq,
                                                float* xs, float* red) {
    if constexpr (!W8) return;
    const uint4* v = reinterpret_cast<const uint4*>(xb);
    float m = 0.f;
    for (int i = threadIdx.x; i < n / 8; i += THREADS) {
        const uint4 u = v[i];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) m = fmaxf(m, fmaxf(fabsf(lo_bf(w[e])), fabsf(hi_bf(w[e]))));
    }
    m = block_max(m, red);
    const float s = m > 0.f ? __fdiv_rn(m, 127.0f) : 1.0f;
    const float inv = __frcp_rn(s);
    for (int i = threadIdx.x; i < n / 8; i += THREADS) {
        const uint4 u = v[i];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
        uint32_t q[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const uint32_t c0 = static_cast<uint8_t>(act_code(lo_bf(w[e]), s, inv));
            const uint32_t c1 = static_cast<uint8_t>(act_code(hi_bf(w[e]), s, inv));
            q[e >> 1] |= (c0 | (c1 << 8)) << (16 * (e & 1));
        }
        reinterpret_cast<uint2*>(xq)[i] = make_uint2(q[0], q[1]);
    }
    if (threadIdx.x == 0) *xs = s;
    __syncthreads();
}

// two bf16 as the 32-bit word (lo, hi)
__device__ __forceinline__ uint32_t pack_bf(float lo, float hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// xb = bf16((x * rsqrt(mean(x^2) + eps)) * w) for x = h, 16 bytes a load;
// the first 2 * THREADS pieces of h stay in registers between the two passes
template <bool W8>
__device__ void stage_norm(const __nv_bfloat16* h, const float* w, int n, float eps,
                           __nv_bfloat16* xb, int8_t* xq, float* xs, float* red) {
    const uint4* hv = reinterpret_cast<const uint4*>(h);
    const int nv = n / 8;
    auto sum_sq = [](const uint4& u) {
        const uint32_t p[4] = {u.x, u.y, u.z, u.w};
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            t += __fmul_rn(lo_bf(p[e]), lo_bf(p[e]));
            t += __fmul_rn(hi_bf(p[e]), hi_bf(p[e]));
        }
        return t;
    };
    auto normed = [&](const uint4& u, int i, float inv) {
        const uint32_t p[4] = {u.x, u.y, u.z, u.w};
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(w) + 2 * i);
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(w) + 2 * i + 1);
        const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            o[e] = pack_bf(__fmul_rn(__fmul_rn(lo_bf(p[e]), inv), ws[2 * e]),
                           __fmul_rn(__fmul_rn(hi_bf(p[e]), inv), ws[2 * e + 1]));
        reinterpret_cast<uint4*>(xb)[i] = make_uint4(o[0], o[1], o[2], o[3]);
    };
    uint4 x[2];
    float ss = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        const int i = threadIdx.x + u * THREADS;
        if (i < nv) x[u] = __ldcg(hv + i);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
        if (threadIdx.x + u * THREADS < nv) ss += sum_sq(x[u]);
    for (int i = threadIdx.x + 2 * THREADS; i < nv; i += THREADS) ss += sum_sq(__ldcg(hv + i));
    ss = block_sum(ss, red);
    const float inv = rsqrtf(__fdiv_rn(ss, static_cast<float>(n)) + eps);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        const int i = threadIdx.x + u * THREADS;
        if (i < nv) normed(x[u], i, inv);
    }
    for (int i = threadIdx.x + 2 * THREADS; i < nv; i += THREADS) normed(__ldcg(hv + i), i, inv);
    __syncthreads();
    quantize_staged<W8>(xb, n, xq, xs, red);
}

// xb = a vector written earlier in this launch (ctx, act): 16 bytes a load,
// up to eight loads of a thread in flight
template <bool W8>
__device__ void stage_copy(const __nv_bfloat16* src, int n, __nv_bfloat16* xb, int8_t* xq,
                           float* xs, float* red) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(xb);
    for (int i0 = threadIdx.x; i0 < n / 8; i0 += 8 * THREADS) {
        uint4 t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (i0 + u * THREADS < n / 8) t[u] = __ldcg(s + i0 + u * THREADS);
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (i0 + u * THREADS < n / 8) d[i0 + u * THREADS] = t[u];
    }
    __syncthreads();
    quantize_staged<W8>(xb, n, xq, xs, red);
}

// a pointer of the weight table
__device__ __forceinline__ const void* tab_ptr(const unsigned long long* tab, int sh, int i) {
    return reinterpret_cast<const void*>(__ldg(tab + sh * TABLE + i));
}

// the first input a lane takes in the segment [kb, kb + kt) of a row, its
// inputs being lane * V, lane * V + 32 * V, ... of the whole row: a row
// split over shards is read in the one-shard order
template <int V>
__device__ __forceinline__ int first_input(int lane, int kb) {
    const int k = lane * V;
    return k >= kb ? k : k + (kb - k + 32 * V - 1) / (32 * V) * (32 * V);
}

// R outputs of linears over the staged activation, by one warp (R = 1 or
// 2): local row row[i] of linear wi[i] in the layer's table `tab`, from
// shard sh[i], its inputs in `nseg` segments of `kt` columns on shards
// sh[i], sh[i] + 1, ... (:func:`locate`), the R rows' loads interleaved.
// Each y[i] is the f32 value before its bf16 rounding; kt % 16 == 0 and
// every row 16-byte aligned (the launcher checks).
template <bool W8, int R>
__device__ __forceinline__ void linear_rows(const unsigned long long* tab, const int (&wi)[R],
                                            const int (&sh)[R], const int (&row)[R], int nseg,
                                            int kt, const __nv_bfloat16* xb, const int8_t* xq,
                                            float xs, int lane, float (&y)[R]) {
    if constexpr (W8) {
        int acc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = 0;
        for (int s = 0, kb = 0; s < nseg; ++s, kb += kt) {
            const int8_t* wr[R];
#pragma unroll
            for (int i = 0; i < R; ++i)
                wr[i] = static_cast<const int8_t*>(tab_ptr(tab, sh[i] + s, T_WQ + wi[i])) +
                        static_cast<size_t>(row[i]) * kt;
#pragma unroll 4
            for (int k = first_input<16>(lane, kb); k < kb + kt; k += 32 * 16) {
                const int4 b = *reinterpret_cast<const int4*>(xq + k);
#pragma unroll
                for (int i = 0; i < R; ++i) {
                    const int4 a = __ldg(reinterpret_cast<const int4*>(wr[i] + (k - kb)));
                    acc[i] = __dp4a(a.x, b.x, acc[i]);
                    acc[i] = __dp4a(a.y, b.y, acc[i]);
                    acc[i] = __dp4a(a.z, b.z, acc[i]);
                    acc[i] = __dp4a(a.w, b.w, acc[i]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
            const float s = __ldg(static_cast<const float*>(tab_ptr(tab, sh[i], T_SQ + wi[i])) +
                                  row[i]);
            y[i] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), xs), s);
        }
    } else {
        float acc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = 0.f;
        for (int s = 0, kb = 0; s < nseg; ++s, kb += kt) {
            const __nv_bfloat16* wr[R];
#pragma unroll
            for (int i = 0; i < R; ++i)
                wr[i] = static_cast<const __nv_bfloat16*>(tab_ptr(tab, sh[i] + s, T_WQ + wi[i])) +
                        static_cast<size_t>(row[i]) * kt;
#pragma unroll 4
            for (int k = first_input<8>(lane, kb); k < kb + kt; k += 32 * 8) {
                const uint4 b = *reinterpret_cast<const uint4*>(xb + k);
#pragma unroll
                for (int i = 0; i < R; ++i) {
                    const uint4 a = __ldg(reinterpret_cast<const uint4*>(wr[i] + (k - kb)));
                    acc[i] = fmaf(lo_bf(a.x), lo_bf(b.x), acc[i]);
                    acc[i] = fmaf(hi_bf(a.x), hi_bf(b.x), acc[i]);
                    acc[i] = fmaf(lo_bf(a.y), lo_bf(b.y), acc[i]);
                    acc[i] = fmaf(hi_bf(a.y), hi_bf(b.y), acc[i]);
                    acc[i] = fmaf(lo_bf(a.z), lo_bf(b.z), acc[i]);
                    acc[i] = fmaf(hi_bf(a.z), hi_bf(b.z), acc[i]);
                    acc[i] = fmaf(lo_bf(a.w), lo_bf(b.w), acc[i]);
                    acc[i] = fmaf(hi_bf(a.w), hi_bf(b.w), acc[i]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) y[i] = lfkt::warp_sum(acc[i]);
    }
}

// The new slot of KV head j, by one warp: k after RoPE (or v) into layer
// `layer` of the ring at pos — bf16, or int8 codes and their scale,
// bit-exact with kv_quantize — on every shard that holds head j (its own,
// or all of them for a head tp does not divide), and the same values into
// the item's staged row.
template <bool KV8, typename KT>
__device__ __forceinline__ void new_slot(const LoopArgs& a, int layer, int pos, int j, bool is_v,
                                         KT* staged, float* staged_scale, int lane) {
    const int hd = a.hd;
    const __nv_bfloat16* src = a.qkv + a.dim + (is_v ? a.n_kv * hd : 0) + j * hd;
    float x[8] = {};                             // this lane's pairs i = lane + 32 p
    float amax = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        const int i = lane + 32 * p;
        if (2 * i < hd) {
            float x1 = ld_bf(src + 2 * i), x2 = ld_bf(src + 2 * i + 1);
            if (!is_v) lfkt::rope_pair(x1, x2, __ldg(a.cos_t + i), __ldg(a.sin_t + i), x1, x2);
            x[2 * p] = x1;
            x[2 * p + 1] = x2;
            amax = fmaxf(amax, fmaxf(fabsf(x1), fabsf(x2)));
        }
    }
    int t0, jl;
    head_at(a, j, t0, jl);
    const int t1 = a.kv_split ? t0 + 1 : a.tp;
    const size_t slot = (static_cast<size_t>(layer) * a.n_kv_local + jl) * a.n_ctx + pos;
    KT v[8];
    float s = 0.f;
    if constexpr (KV8) {
        float inv;
        s = lfkt::kv_row_scale(amax, inv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = lfkt::kv_quantize_value(x[e], inv);
        if (lane == 0) *staged_scale = s;
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(x[e]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        const int i = lane + 32 * p;
        if (2 * i < hd) {
            staged[2 * i] = v[2 * p];
            staged[2 * i + 1] = v[2 * p + 1];
        }
    }
    for (int t = t0; t < t1; ++t) {
        KT* dst = static_cast<KT*>(is_v ? a.rv[t] : a.rk[t]) + slot * hd;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const int i = lane + 32 * p;
            if (2 * i < hd) {
                dst[2 * i] = v[2 * p];
                dst[2 * i + 1] = v[2 * p + 1];
            }
        }
        if (KV8 && lane == 0) (is_v ? a.rvs[t] : a.rks[t])[slot] = s;
    }
}

// the chunk of an attention item: the smallest power of two in [CHUNK_MIN,
// CHUNK_MAX] whose aligned chunks of [lo, pos] give at most one item a block
__device__ __forceinline__ int chunk_keys(int lo, int pos, int n_kv, int blocks) {
    int c = CHUNK_MIN;
    while (c < CHUNK_MAX && n_kv * (pos / c - lo / c + 1) > blocks) c <<= 1;
    return c;
}

// P2: the attention of layer `layer` over ring slots [lo, pos], a work item
// (KV head j x key chunk) a block; see the header for the two steps.
template <bool KV8>
__device__ void attention_phase(const LoopArgs& a, int layer, int pos, unsigned char* sm,
                                int* flag) {
    using KT = typename std::conditional<KV8, int8_t, __nv_bfloat16>::type;
    const int hd = a.hd, n_kv = a.n_kv, n_ctx = a.n_ctx;
    const int group = a.n_heads / n_kv;
    const int rb = hd * static_cast<int>(sizeof(KT));
    const AttnSmem L(group, hd, rb);
    float* qf = reinterpret_cast<float*>(sm + L.q);
    KT* kst = reinterpret_cast<KT*>(sm + L.k);
    KT* vst = reinterpret_cast<KT*>(sm + L.v);
    float* kss = reinterpret_cast<float*>(sm + L.ks);
    float* vss = reinterpret_cast<float*>(sm + L.vs);
    float* sc = reinterpret_cast<float*>(sm + L.sc);
    float* ml = reinterpret_cast<float*>(sm + L.ml);

    // head j's rows of this layer, K or V, on the shard it is read from,
    // and their scales (int8 ring)
    auto head_rows = [&](int j, bool v) -> const KT* {
        int t, jl;
        head_at(a, j, t, jl);
        return static_cast<const KT*>(v ? a.rv[t] : a.rk[t]) +
               (static_cast<size_t>(layer) * a.n_kv_local + jl) * n_ctx * hd;
    };
    auto head_scales = [&](int j, bool v) -> const float* {
        if constexpr (!KV8) return nullptr;
        int t, jl;
        head_at(a, j, t, jl);
        return (v ? a.rvs[t] : a.rks[t]) + (static_cast<size_t>(layer) * a.n_kv_local + jl) * n_ctx;
    };
    const size_t heads_chunks = static_cast<size_t>(a.n_heads) * a.max_chunks;
    float* po = a.part;                          // (n_heads, max_chunks, hd) P.V sums
    float* pml = po + heads_chunks * hd;         // (n_heads, max_chunks, 2) (m, l)
    float* ps = pml + heads_chunks * 2;          // (n_heads, n_ctx) scores
    unsigned int* scored = a.cnt;                // (n_kv) items past step 1
    unsigned int* summed = a.cnt + n_kv;         // (n_kv) items past step 2

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int lo = a.window > 0 ? max(0, pos - a.window + 1) : 0;
    const int C = chunk_keys(lo, pos, n_kv, gridDim.x);
    const int first = lo / C, n_chunks = pos / C - first + 1;
    const int items = n_kv * n_chunks;
    const int pieces = rb / 16;
    // the item's head, chunk and keys [c0, c1)
    auto item = [&](int it, int& j, int& ci, int& c0, int& c1) {
        j = it % n_kv;
        ci = it / n_kv;
        c0 = max(lo, (first + ci) * C);
        c1 = min(pos + 1, (first + ci + 1) * C);
    };
    // rows [c0, c1) of the ring `ring` into `stage`, `stride` bytes apart
    // (all in flight), but slot `skip`, and their scales
    auto stage_rows = [&](const KT* ring, KT* stage, int stride, const float* scale,
                          float* sscale, size_t row0, int n, int c0, int skip) {
        for (int i = threadIdx.x; i < n * pieces; i += THREADS) {
            const int r = i / pieces;
            if (c0 + r == skip) continue;
            const int at = (i - r * pieces) * 16;
            cp_async16(reinterpret_cast<unsigned char*>(stage) + r * stride + at,
                       reinterpret_cast<const unsigned char*>(ring) + (row0 + r) * rb + at);
        }
        if constexpr (KV8) {
            for (int i = threadIdx.x; i < n; i += THREADS)
                if (c0 + i != skip) sscale[i] = __ldcg(scale + row0 + i);
        }
    };

    // Step 1, every item of this block: the scores of its chunk and the
    // chunk's (m, l) per query head, then an arrival on its head's counter.
    int last = -1;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
        int j, ci, c0, c1;
        item(it, j, ci, c0, c1);
        const int n = c1 - c0;
        stage_rows(head_rows(j, false), kst, rb + 16, head_scales(j, false), kss, c0, n, c0,
                   pos);
        stage_rows(head_rows(j, true), vst, rb, head_scales(j, true), vss, c0, n, c0, pos);
        // the group's query rows after RoPE
        const int half = hd >> 1;
        for (int i = threadIdx.x; i < group * half; i += THREADS) {
            const int g = i / half, pr = i - g * half;
            const __nv_bfloat16* src = a.qkv + (j * group + g) * hd + 2 * pr;
            float o1, o2;
            lfkt::rope_pair(ld_bf(src), ld_bf(src + 1), __ldg(a.cos_t + pr), __ldg(a.sin_t + pr), o1, o2);
            qf[g * (hd + 4) + 2 * pr] = o1;
            qf[g * (hd + 4) + 2 * pr + 1] = o2;
        }
        // the new slot: k (warp 0) and v (warp 1)
        if (c1 == pos + 1 && warp < 2) {
            const int r = pos - c0;
            if (warp == 0)
                new_slot<KV8>(a, layer, pos, j, false,
                              reinterpret_cast<KT*>(reinterpret_cast<unsigned char*>(kst) +
                                                    r * (rb + 16)),
                              kss + r, lane);
            else
                new_slot<KV8>(a, layer, pos, j, true, vst + r * hd, vss + r, lane);
        }
        cp_async_wait_all();
        __syncthreads();
        // s = (q . k) * hd^-0.5 [* k_s]: a thread a (key, head) — the threads
        // of a key's heads read its row at once (broadcast), the padded rows
        // of neighbouring keys and heads fall on other banks
        for (int i = threadIdx.x; i < n * group; i += THREADS) {
            const int c = i / group, g = i - c * group;
            const float* qr = qf + g * (hd + 4);
            const unsigned char* kr = reinterpret_cast<const unsigned char*>(kst) + c * (rb + 16);
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            for (int d = 0; d < hd; d += 4) {
                const float4 q4 = *reinterpret_cast<const float4*>(qr + d);
                float k4[4];
                if constexpr (KV8) {
                    const uint32_t w = *reinterpret_cast<const uint32_t*>(kr + d);
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        k4[e] = static_cast<float>(static_cast<int8_t>(w >> (8 * e)));
                } else {
                    const uint2 w = *reinterpret_cast<const uint2*>(kr + 2 * d);
                    k4[0] = lo_bf(w.x);
                    k4[1] = hi_bf(w.x);
                    k4[2] = lo_bf(w.y);
                    k4[3] = hi_bf(w.y);
                }
                acc[0] = fmaf(q4.x, k4[0], acc[0]);
                acc[1] = fmaf(q4.y, k4[1], acc[1]);
                acc[2] = fmaf(q4.z, k4[2], acc[2]);
                acc[3] = fmaf(q4.w, k4[3], acc[3]);
            }
            float sv = __fmul_rn((acc[0] + acc[1]) + (acc[2] + acc[3]), a.sm_scale);
            if constexpr (KV8) sv = __fmul_rn(sv, kss[c]);
            sc[g * CHUNK_MAX + c] = sv;
            __stcg(ps + static_cast<size_t>(j * group + g) * n_ctx + c0 + c, sv);
        }
        __syncthreads();
        for (int g = warp; g < group; g += WARPS) {
            const float* s = sc + g * CHUNK_MAX;
            float m = -INFINITY;
            for (int c = lane; c < n; c += 32) m = fmaxf(m, s[c]);
            m = lfkt::warp_max(m);
            float l = 0.f;
            for (int c = lane; c < n; c += 32) l += expf(s[c] - m);
            l = lfkt::warp_sum(l);
            if (lane == 0) {
                float* dst = pml + (static_cast<size_t>(j * group + g) * a.max_chunks + ci) * 2;
                __stcg(dst, m);
                __stcg(dst + 1, l);
            }
        }
        __syncthreads();
        if (threadIdx.x == 0) red_add_release(scored + j, 1u);
        last = it;
    }

    // Step 2, newest item first (its K/V rows and scores are still staged):
    // once every chunk of the head is scored, p = bf16(exp(s - M) / L
    // [* v_s]) with the head's max M and sum L, the chunk's P.V, and an
    // arrival; the last item of the head sums the chunks into ctx and
    // returns both counters to zero.  Every block finished step 1 before
    // it waits here, so the wait always ends.
    for (int it = last; it >= 0; it -= gridDim.x) {
        int j, ci, c0, c1;
        item(it, j, ci, c0, c1);
        const int n = c1 - c0;
        if (threadIdx.x == 0) {
            while (ld_acquire(scored + j) < static_cast<unsigned>(n_chunks)) {
            }
        }
        __syncthreads();
        if (it != last) {
            // an earlier item of this block: its V rows (slot pos is in the
            // ring by now) and its scores again
            stage_rows(head_rows(j, true), vst, rb, head_scales(j, true), vss, c0, n, c0, -1);
            for (int i = threadIdx.x; i < group * n; i += THREADS) {
                const int g = i / n, c = i - g * n;
                sc[g * CHUNK_MAX + c] = __ldcg(ps + static_cast<size_t>(j * group + g) * n_ctx + c0 + c);
            }
            cp_async_wait_all();
        }
        for (int g = warp; g < group; g += WARPS) {
            const float2* mlg = reinterpret_cast<const float2*>(pml) +
                                static_cast<size_t>(j * group + g) * a.max_chunks;
            // (m, l) of the lane's first chunk kept, the rest read again
            const float2 own = lane < n_chunks ? __ldcg(mlg + lane) : make_float2(-INFINITY, 0.f);
            float M = own.x;
            for (int k = lane + 32; k < n_chunks; k += 32) M = fmaxf(M, __ldcg(mlg + k).x);
            M = lfkt::warp_max(M);
            float l = lane < n_chunks ? own.y * expf(own.x - M) : 0.f;
            for (int k = lane + 32; k < n_chunks; k += 32) {
                const float2 t = __ldcg(mlg + k);
                l = fmaf(t.y, expf(t.x - M), l);
            }
            l = lfkt::warp_sum(l);
            if (lane == 0) {
                ml[2 * g] = M;
                ml[2 * g + 1] = l;
            }
        }
        __syncthreads();
        for (int i = threadIdx.x; i < group * n; i += THREADS) {
            const int g = i / n, c = i - g * n;
            float p = __fdiv_rn(expf(sc[g * CHUNK_MAX + c] - ml[2 * g]), ml[2 * g + 1]);
            if constexpr (KV8) p = __fmul_rn(p, vss[c]);
            sc[g * CHUNK_MAX + c] = round_bf(p);         // probabilities rounded to bf16
        }
        __syncthreads();
        // the chunk's P.V of each query head: a thread per (head, d)
        for (int i = threadIdx.x; i < group * hd; i += THREADS) {
            const int g = i / hd, d = i - g * hd;
            const float* p = sc + g * CHUNK_MAX;
            float acc = 0.f;
            for (int c = 0; c < n; ++c) acc = fmaf(p[c], to_f(vst[c * hd + d]), acc);
            __stcg(po + (static_cast<size_t>(j * group + g) * a.max_chunks + ci) * hd + d, acc);
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            const bool all =
                atom_add_acq_rel(summed + j, 1u) == static_cast<unsigned>(n_chunks - 1);
            if (all) {
                atomicExch(scored + j, 0u);
                atomicExch(summed + j, 0u);
            }
            *flag = all;
        }
        __syncthreads();
        if (*flag) {
            // ctx = bf16(sum of the chunks' P.V): columns of 4 outputs, the
            // chunks of a column split over `parts` threads (all their
            // 16-byte loads in flight), the parts summed in shared memory
            const int cols = group * hd / 4;
            const int parts = cols < THREADS ? THREADS / cols : 1;
            float4* psum = reinterpret_cast<float4*>(qf);       // parts x cols: q, K and V are spent
            for (int i = threadIdx.x; i < parts * cols; i += THREADS) {
                const int col = i % cols, part = i / cols;
                const int g = col / (hd / 4), d = 4 * col - g * hd;
                const float* og = po + static_cast<size_t>(j * group + g) * a.max_chunks * hd + d;
                float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
                for (int k = part; k < n_chunks; k += parts) {
                    const float4 t = __ldcg(reinterpret_cast<const float4*>(og + static_cast<size_t>(k) * hd));
                    acc.x += t.x;
                    acc.y += t.y;
                    acc.z += t.z;
                    acc.w += t.w;
                }
                psum[i] = acc;
            }
            __syncthreads();
            for (int col = threadIdx.x; col < cols; col += THREADS) {
                float4 acc = psum[col];
                for (int part = 1; part < parts; ++part) {
                    const float4 t = psum[part * cols + col];
                    acc.x += t.x;
                    acc.y += t.y;
                    acc.z += t.z;
                    acc.w += t.w;
                }
                const int g = col / (hd / 4), d = 4 * col - g * hd;
                __nv_bfloat16* dst = a.ctx + (j * group + g) * hd + d;
                dst[0] = __float2bfloat16_rn(acc.x);
                dst[1] = __float2bfloat16_rn(acc.y);
                dst[2] = __float2bfloat16_rn(acc.z);
                dst[3] = __float2bfloat16_rn(acc.w);
            }
        }
        __syncthreads();                         // the next item reuses shared memory
    }
}

template <bool W8, bool KV8>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) decode_loop_kernel(const LoopArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int maxk = ((a.dim > a.ffn ? a.dim : a.ffn) + 15) & ~15;
    const int region = region_bytes(a.dim, a.ffn, a.n_heads / a.n_kv, a.hd, a.hd * (KV8 ? 1 : 2));
    __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(smem);                 // maxk
    int8_t* xq = reinterpret_cast<int8_t*>(xb + maxk);                          // maxk
    float* red = reinterpret_cast<float*>(smem + region);                       // WARPS
    float* xs = red + WARPS;                                                    // 1
    int* flag = reinterpret_cast<int*>(xs + 1);                                 // 1

    const int lane = threadIdx.x & 31;
    const int gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int nwarps = gridDim.x * WARPS;
    const int dim = a.dim, ffn = a.ffn;
    const int kvd = a.n_kv * a.hd;
    // the token's ring slot, from device memory: a launch captured in a CUDA
    // graph decodes at whatever slot the step's state holds at replay.  Every
    // block reads the same value, so a slot outside the ring (the caller
    // checks its host mirror) ends every block here, before any barrier.
    const long long slot = a.positions[0];
    if (slot < 0 || slot >= a.n_ctx) return;
    const int pos = static_cast<int>(slot);

    // h[r] += bf16(row r of linear w . staged x) for every row of h, two
    // rows a warp (both rows of one linear: the same K segments)
    auto residual_rows = [&](const unsigned long long* tab, int w, int K) {
        for (int r = gwarp; r < dim; r += 2 * nwarps) {
            int sh0, row0, sh1, row1, nseg, kt;
            locate(a, w, r, dim, K, sh0, row0, nseg, kt);
            float y[2];
            if (r + nwarps < dim) {
                locate(a, w, r + nwarps, dim, K, sh1, row1, nseg, kt);
                linear_rows<W8, 2>(tab, {w, w}, {sh0, sh1}, {row0, row1}, nseg, kt, xb, xq, *xs,
                                   lane, y);
            } else {
                float y1[1];
                linear_rows<W8, 1>(tab, {w}, {sh0}, {row0}, nseg, kt, xb, xq, *xs, lane, y1);
                y[0] = y1[0];
            }
            if (lane == 0) {
                a.h[r] = __float2bfloat16_rn(ld_bf(a.h + r) + round_bf(y[0]));
                if (r + nwarps < dim)
                    a.h[r + nwarps] = __float2bfloat16_rn(ld_bf(a.h + r + nwarps) + round_bf(y[1]));
            }
        }
    };

    for (int l = 0; l < a.n_layers; ++l) {
        const int layer = a.layer0 + l;
        // the layer's tp rows of the table; the norms are shard 0's
        const unsigned long long* tab = a.table + static_cast<size_t>(layer) * a.tp * TABLE;

        // P1: hn = rms_norm(h); raw q | k | v rows
        stage_norm<W8>(a.h, static_cast<const float*>(tab_ptr(tab, 0, T_ATTN_NORM)), dim, a.eps,
                       xb, xq, xs, red);
        // row r of q | k | v: its linear, shard and local row (K = dim whole:
        // q, k and v are never row-split)
        auto qkv_row = [&](int r, int& which, int& sh, int& row) {
            which = r < dim ? 0 : (r < dim + kvd ? 1 : 2);
            int nseg, kt;
            locate(a, which, which == 0 ? r : r - dim - (which - 1) * kvd, which ? kvd : dim,
                   dim, sh, row, nseg, kt);
        };
        for (int r = gwarp; r < dim + 2 * kvd; r += 2 * nwarps) {
            int w0, sh0, row0;
            qkv_row(r, w0, sh0, row0);
            if (r + nwarps < dim + 2 * kvd) {
                int w1, sh1, row1;
                qkv_row(r + nwarps, w1, sh1, row1);
                float y[2];
                linear_rows<W8, 2>(tab, {w0, w1}, {sh0, sh1}, {row0, row1}, 1, dim, xb, xq, *xs,
                                   lane, y);
                if (lane == 0) {
                    a.qkv[r] = __float2bfloat16_rn(y[0]);
                    a.qkv[r + nwarps] = __float2bfloat16_rn(y[1]);
                }
            } else {
                float y[1];
                linear_rows<W8, 1>(tab, {w0}, {sh0}, {row0}, 1, dim, xb, xq, *xs, lane, y);
                if (lane == 0) a.qkv[r] = __float2bfloat16_rn(y[0]);
            }
        }
        grid_sync(a.bar);

        // P2: the new K/V slot and the attention over ring slots [lo, pos]
        attention_phase<KV8>(a, layer, pos, smem, flag);
        grid_sync(a.bar);

        // P3: h += ctx Wo^T
        stage_copy<W8>(a.ctx, dim, xb, xq, xs, red);
        residual_rows(tab, T_WO, dim);
        grid_sync(a.bar);

        // P4: hn = rms_norm(h); act = bf16(silu(gate)) * up (K = dim whole)
        stage_norm<W8>(a.h, static_cast<const float*>(tab_ptr(tab, 0, T_FFN_NORM)), dim, a.eps,
                       xb, xq, xs, red);
        for (int r = gwarp; r < ffn; r += nwarps) {
            int shg, rowg, shu, rowu, nseg, kt;
            locate(a, T_WG, r, ffn, dim, shg, rowg, nseg, kt);
            locate(a, T_WU, r, ffn, dim, shu, rowu, nseg, kt);
            float y[2];
            linear_rows<W8, 2>(tab, {T_WG, T_WU}, {shg, shu}, {rowg, rowu}, 1, dim, xb, xq, *xs,
                               lane, y);
            const float g = round_bf(y[0]), u = round_bf(y[1]);
            if (lane == 0) {
                const float sg = round_bf(__fdiv_rn(g, 1.0f + expf(-g)));
                a.act[r] = __float2bfloat16_rn(__fmul_rn(sg, u));
            }
        }
        grid_sync(a.bar);

        // P5: h += act Wd^T
        stage_copy<W8>(a.act, ffn, xb, xq, xs, red);
        residual_rows(tab, T_WD, ffn);
        if (l + 1 < a.n_layers) grid_sync(a.bar);
    }
}

size_t smem_bytes(int dim, int ffn, int group, int hd, int rb) {
    return static_cast<size_t>(region_bytes(dim, ffn, group, hd, rb)) +
           sizeof(float) * (WARPS + 2);
}

template <bool W8, bool KV8>
int launch(const LoopArgs& a, cudaStream_t stream) {
    const void* kern = reinterpret_cast<const void*>(decode_loop_kernel<W8, KV8>);
    const size_t smem = smem_bytes(a.dim, a.ffn, a.n_heads / a.n_kv, a.hd, a.hd * (KV8 ? 1 : 2));
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

// `ring`: a host array of tp x 4 addresses, each shard's K, V, K scale and
// V scale (the scales 0 over a bf16 ring); `modes`: M_* of linear w at bits
// 2w, 2w + 1 (row only for wo and w_down); `kv_split`: the ring's heads
// split over tp, else every shard holds all of them
LFKT_API int lfkt_decode_loop(const void* table, void* h, const void* ring, void* qkv, void* ctx,
                              void* act, const void* cos_t, const void* sin_t,
                              const void* positions, void* bar, void* part, void* cnt, int layer0,
                              int n_layers, int dim, int ffn, int n_heads, int n_kv, int hd,
                              int n_ctx, int window, int max_chunks, int tp, int modes,
                              int kv_split, float eps, float sm_scale, int w_int8, int kv_int8,
                              void* stream) {
    if (n_layers <= 0) return 0;
    if ((hd != 32 && hd != 64 && hd != 128 && hd != 256) || n_heads * hd != dim || n_kv <= 0 ||
        n_heads % n_kv || dim % 16 || ffn % 16 || ffn <= 0 || n_ctx <= 0 || positions == nullptr ||
        layer0 < 0 || part == nullptr || cnt == nullptr ||
        max_chunks < (n_ctx - 1) / CHUNK_MIN + 1 || tp < 1 || tp > MAX_TP || ring == nullptr ||
        (kv_split && n_kv % tp) || (modes >> (2 * LINEARS)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int kvd = n_kv * hd;
    const int n_out[LINEARS] = {dim, kvd, kvd, dim, ffn, ffn, dim};
    const int k_in[LINEARS] = {dim, dim, dim, dim, dim, dim, ffn};
    for (int w = 0; w < LINEARS; ++w) {
        const int m = (modes >> (2 * w)) & 3;
        const bool row_ok = (w == T_WO || w == T_WD) && k_in[w] % tp == 0 && (k_in[w] / tp) % 16 == 0;
        if (m > M_ROW || (m == M_COL && n_out[w] % tp) || (m == M_ROW && !row_ok))
            return static_cast<int>(cudaErrorInvalidValue);
    }
    LoopArgs a{};
    const auto* rt = static_cast<const unsigned long long*>(ring);
    for (int t = 0; t < tp; ++t) {
        a.rk[t] = reinterpret_cast<void*>(rt[4 * t]);
        a.rv[t] = reinterpret_cast<void*>(rt[4 * t + 1]);
        a.rks[t] = reinterpret_cast<float*>(rt[4 * t + 2]);
        a.rvs[t] = reinterpret_cast<float*>(rt[4 * t + 3]);
        if (a.rk[t] == nullptr || a.rv[t] == nullptr ||
            (kv_int8 && (a.rks[t] == nullptr || a.rvs[t] == nullptr)))
            return static_cast<int>(cudaErrorInvalidValue);
    }
    a.table = static_cast<const unsigned long long*>(table);
    a.h = static_cast<__nv_bfloat16*>(h);
    a.qkv = static_cast<__nv_bfloat16*>(qkv);
    a.ctx = static_cast<__nv_bfloat16*>(ctx);
    a.act = static_cast<__nv_bfloat16*>(act);
    a.cos_t = static_cast<const float*>(cos_t);
    a.sin_t = static_cast<const float*>(sin_t);
    a.positions = static_cast<const long long*>(positions);
    a.bar = static_cast<unsigned int*>(bar);
    a.part = static_cast<float*>(part);
    a.cnt = static_cast<unsigned int*>(cnt);
    a.layer0 = layer0;
    a.n_layers = n_layers;
    a.dim = dim;
    a.ffn = ffn;
    a.n_heads = n_heads;
    a.n_kv = n_kv;
    a.hd = hd;
    a.n_ctx = n_ctx;
    a.window = window;
    a.max_chunks = max_chunks;
    a.tp = tp;
    a.modes = modes;
    a.kv_split = kv_split ? 1 : 0;
    a.n_kv_local = kv_split ? n_kv / tp : n_kv;
    a.eps = eps;
    a.sm_scale = sm_scale;
    auto s = static_cast<cudaStream_t>(stream);
    if (w_int8) return kv_int8 ? launch<true, true>(a, s) : launch<true, false>(a, s);
    return kv_int8 ? launch<false, true>(a, s) : launch<false, false>(a, s);
}
