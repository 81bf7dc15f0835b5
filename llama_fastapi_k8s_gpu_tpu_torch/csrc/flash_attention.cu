// Causal (+ optional sliding-window) GQA flash attention of S new queries
// over one layer's head-major KV ring, at cache offset pos_offset.
//   q   (S, H, HD)       bf16   queries, token-major (the model's layout)
//   k,v (n_kv, n_ctx, HD) bf16  the ring; slots past pos_offset+S may hold
//                               stale data and are hidden by the causal mask
//       or int8, with ks,vs (n_kv, n_ctx) f32 per-token scales (the int8 KV
//                               cache, ops/kvquant.py)
//   out (S, H, HD)       bf16
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/attention.py::_attn_kernel
// (flash_attention), both branches, with the reference's arithmetic: both
// contractions on the tensor cores with f32 accumulation, the online
// softmax in f32, and the unnormalised probability tile rounded to bf16
// before P.V (on the int8 ring after multiplying in the value scales:
// the scale-last form, score = (q . k_int8) * sm_scale * ks[key] and
// p * vs[key] before the rounding, so no bf16 ring is ever materialised).
//
// Bound on the H100: at a 256-token prompt slice the work is 4*HD flops
// per visible (query head, key) pair — 3.76 GFLOP at offset 768, 3.8 us at
// the bf16 tensor-core peak — against a few MB of q, out and ring; the
// call is small, so latency and filling the SMs set its time.  The design:
//   - a block owns one KV head and 64 query rows: 64/group tokens times the
//     group heads that share the KV head (row = token * group + head, the
//     reference's GQA fold; in the (S, H, HD) layout a token's group heads
//     are contiguous).  Each K/V tile crosses into shared memory once per
//     64 rows, and at S = 256, group 4 the grid is 16 x 8 = 128 blocks;
//     the blocks with the longest key ranges are launched first;
//   - four warps, each owning 16 rows, run mma.sync m16n8k16 (bf16 in, f32
//     accumulate) for S = Q.K^T and for O += P.V, operands from shared
//     memory by ldmatrix (.trans for V).  Q's fragments are loaded once
//     and stay in registers; the score accumulators, scaled, exponentiated
//     and rounded to bf16, are P.V's A fragments as they lie (the
//     FlashAttention-2 register layout), so P never touches shared memory.
//     mma.sync, not wgmma: a block walks ~16 key tiles, so latency rules,
//     and the register-resident P needs no shared-memory round trip;
//   - key tiles of 64 are copied with 16-byte cp.async, the next one in
//     flight while the warps multiply this one (two stages, one barrier a
//     tile), into rows whose 16-byte chunks are XOR-swizzled by the row so
//     that every ldmatrix is free of bank conflicts.  bf16 K+V at HD 128:
//     64 KB of the 80 KB of dynamic shared memory;
//   - the int8 ring stages the raw tile (half the bytes) and its 64 key and
//     value scales, two stages deep, and widens it once per block into the
//     bf16 tile (exact for [-127, 127]; a second barrier a tile); the key
//     scales multiply the score columns, the value scales p;
//   - tiles are classified as the reference does: those wholly in the
//     masked future or wholly behind the window are never visited,
//     interior tiles skip the mask, edge tiles mask with -inf, and a row
//     whose keys are all masked so far takes its exponent's base as 0, so
//     it never sees exp(-inf - -inf).  Keys past the block's last query are
//     zero-filled, never read; padded rows past S and a row with no visible
//     key write nothing and zeros; outputs are rounded once to bf16.
#include "common.cuh"

namespace {

constexpr int BM = 64;               // query rows a block
constexpr int BN = 64;               // keys a tile
constexpr int WARPS = BM / 16;       // one m16 row tile a warp
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// dynamic shared memory, in bytes: Q | bf16 K and V tiles (two stages; one
// for the int8 ring, widened from its raw stage) | raw int8 K, V and their
// scales (two stages, int8 ring only)
template <int HD, bool QUANT>
struct Layout {
    static constexpr int Q = BM * HD * 2;
    static constexpr int TILE = BN * HD * 2;
    static constexpr int STAGES = QUANT ? 1 : 2;
    static constexpr int RAW = 2 * BN * HD + 2 * BN * 4;
    static constexpr int BYTES = Q + STAGES * 2 * TILE + (QUANT ? 2 * RAW : 0);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest N committed groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a . b over one m16n8k16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {   // 2^x; 2^-inf = 0
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// bytes sh/8 and sh/8 + 1 of w, signed, as two bf16 (exact)
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t w, int sh) {
    return pack_bf16(static_cast<float>(static_cast<int8_t>(w >> sh)),
                     static_cast<float>(static_cast<int8_t>(w >> (sh + 8))));
}

// byte offset of 16-byte chunk `ch` of row `row` in a tile of HD-wide bf16
// rows: the chunk index XOR the row's low three bits, so the 8 rows an
// ldmatrix reads at one chunk fall in 8 distinct bank groups
template <int HD>
__device__ __forceinline__ uint32_t tile_off(int row, int ch) {
    return row * (HD * 2) + ((ch ^ (row & 7)) << 4);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int HD, bool QUANT>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const void* __restrict__ k,
                       const void* __restrict__ v,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       __nv_bfloat16* __restrict__ out,
                       int S, int H, int n_ctx, int group, int pos_offset,
                       float sm_scale, int window) {
    using L = Layout<HD, QUANT>;
    constexpr int CH = HD / 8;       // 16-byte chunks of a bf16 row
    constexpr int RCH = HD / 16;     // 16-byte chunks of an int8 row
    constexpr int KSTEPS = HD / 16;  // k-steps of Q.K^T
    constexpr int NT = BN / 8;       // score n-tiles (keys)
    constexpr int OT = HD / 8;       // output n-tiles (dims)
    static_assert(THREADS == 2 * BN, "one scale a thread");
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t s_q = smem_u32(smem);
    const uint32_t s_kv = s_q + L::Q;          // stage st: K at +2*st*TILE, V TILE further
    unsigned char* raw = smem + L::Q + L::STAGES * 2 * L::TILE;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c = lane & 3;     // fragment row and column pair
    const int tpb = BM / group;                // tokens a block
    const int t0 = (gridDim.x - 1 - blockIdx.x) * tpb;
    const int kvh = blockIdx.y;
    const int q_lo = pos_offset + t0;
    const int q_hi = pos_offset + min(t0 + tpb, S) - 1;
    const int key_end = q_hi + 1;              // <= n_ctx: the launcher checks
    const int key_begin = window > 0 ? max(0, q_lo - window + 1) / BN * BN : 0;
    const int n_tiles = (key_end - key_begin + BN - 1) / BN;
    const size_t head = static_cast<size_t>(kvh) * n_ctx;

    // Q: row r is token t0 + r / group, head kvh * group + r % group
    for (int i = tid; i < BM * CH; i += THREADS) {
        const int r = i / CH, ch = i % CH;
        const int t = t0 + r / group;
        const bool ok = t < S;
        const __nv_bfloat16* src =
            ok ? q + (static_cast<size_t>(t) * H + kvh * group + r % group) * HD + ch * 8 : q;
        cp_async16(s_q + tile_off<HD>(r, ch), src, ok);
    }
    cp_async_commit();

    // the keys kb .. kb+63 into stage st (raw stage st for the int8 ring)
    auto load_tile = [&](int st, int kb) {
        if constexpr (!QUANT) {
            const __nv_bfloat16* kh = static_cast<const __nv_bfloat16*>(k) + head * HD;
            const __nv_bfloat16* vh = static_cast<const __nv_bfloat16*>(v) + head * HD;
            const uint32_t dk = s_kv + st * 2 * L::TILE, dv = dk + L::TILE;
            for (int i = tid; i < BN * CH; i += THREADS) {
                const int r = i / CH, ch = i % CH;
                const bool ok = kb + r < key_end;
                const size_t off = ok ? static_cast<size_t>(kb + r) * HD + ch * 8 : 0;
                cp_async16(dk + tile_off<HD>(r, ch), kh + off, ok);
                cp_async16(dv + tile_off<HD>(r, ch), vh + off, ok);
            }
        } else {
            const int8_t* kh = static_cast<const int8_t*>(k) + head * HD;
            const int8_t* vh = static_cast<const int8_t*>(v) + head * HD;
            const uint32_t dk = smem_u32(raw + st * L::RAW), dv = dk + BN * HD;
            for (int i = tid; i < BN * RCH; i += THREADS) {
                const int r = i / RCH, ch = i % RCH;
                const bool ok = kb + r < key_end;
                const size_t off = ok ? static_cast<size_t>(kb + r) * HD + ch * 16 : 0;
                cp_async16(dk + r * HD + ch * 16, kh + off, ok);
                cp_async16(dv + r * HD + ch * 16, vh + off, ok);
            }
            const int r = tid & (BN - 1);           // 64 key scales, then 64 value scales
            const bool ok = kb + r < key_end;
            cp_async4(dv + BN * HD + tid * 4, (tid < BN ? ks : vs) + head + (ok ? kb + r : 0), ok);
        }
    };

    load_tile(0, key_begin);
    cp_async_commit();
    cp_async_wait<1>();                        // Q landed
    __syncthreads();
    uint32_t qf[KSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
        ldsm_x4(s_q + tile_off<HD>(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                   2 * kk + (lane >> 4)), qf[kk]);

    // this thread's two rows: g and g + 8 of the warp's 16
    const int row0 = warp * 16 + g;
    const int qp0 = pos_offset + t0 + row0 / group;
    const int qp1 = pos_offset + t0 + (row0 + 8) / group;
    const float scale = sm_scale * LOG2E;      // scores in base 2
    float m0 = -INFINITY, m1 = -INFINITY;      // running row max (base 2)
    float l0 = 0.f, l1 = 0.f;                  // this thread's part of the row sum
    float o[OT][4];
#pragma unroll
    for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
        const int kb = key_begin + it * BN;
        cp_async_wait<0>();                    // tile it landed (this thread's copies)
        __syncthreads();                       // ... everyone's; tile it-1 is done with
        if (it + 1 < n_tiles) {
            load_tile((it + 1) & 1, kb + BN);
            cp_async_commit();
        }
        const float* ksc = nullptr;
        const float* vsc = nullptr;
        int st = 0;
        if constexpr (QUANT) {
            // widen the raw int8 tile into the bf16 one (chunk ch of a raw row
            // is chunks 2ch and 2ch+1 of the bf16 row)
            const unsigned char* src = raw + (it & 1) * L::RAW;
            for (int i = tid; i < 2 * BN * RCH; i += THREADS) {
                const int m = i / (BN * RCH), r = (i / RCH) % BN, ch = i % RCH;
                const uint4 w = *reinterpret_cast<const uint4*>(src + m * BN * HD + r * HD + ch * 16);
                unsigned char* dst = smem + L::Q + m * L::TILE;
                *reinterpret_cast<uint4*>(dst + tile_off<HD>(r, 2 * ch)) =
                    make_uint4(i8x2_bf16x2(w.x, 0), i8x2_bf16x2(w.x, 16),
                               i8x2_bf16x2(w.y, 0), i8x2_bf16x2(w.y, 16));
                *reinterpret_cast<uint4*>(dst + tile_off<HD>(r, 2 * ch + 1)) =
                    make_uint4(i8x2_bf16x2(w.z, 0), i8x2_bf16x2(w.z, 16),
                               i8x2_bf16x2(w.w, 0), i8x2_bf16x2(w.w, 16));
            }
            ksc = reinterpret_cast<const float*>(src + 2 * BN * HD);
            vsc = ksc + BN;
            __syncthreads();
        } else {
            st = it & 1;
        }
        const uint32_t sk = s_kv + st * 2 * L::TILE, sv = sk + L::TILE;

        // S = Q . K^T for the warp's 16 rows x 64 keys
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
            for (int p = 0; p < NT / 2; ++p) {
                uint32_t b[4];
                ldsm_x4(sk + tile_off<HD>(16 * p + (lane & 7) + (lane >> 4) * 8,
                                          2 * kk + ((lane >> 3) & 1)), b);
                mma_bf16(s[2 * p], qf[kk], b[0], b[1]);
                mma_bf16(s[2 * p + 1], qf[kk], b[2], b[3]);
            }
        }

        // online softmax: element e of n-tile j is row (e < 2 ? g : g+8),
        // key kb + 8j + 2c + (e & 1)
        const bool edge = !(kb + BN - 1 <= q_lo && (window == 0 || kb > q_hi - window));
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int kl = 8 * j + 2 * c + (e & 1);
                float x = s[j][e] * (QUANT ? scale * ksc[kl] : scale);
                if (edge) {
                    const int key = kb + kl, qp = e < 2 ? qp0 : qp1;
                    if (key > qp || (window > 0 && key <= qp - window)) x = -INFINITY;
                }
                s[j][e] = x;
                if (e < 2) mx0 = fmaxf(mx0, x);
                else mx1 = fmaxf(mx1, x);
            }
        }
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        const float mu0 = mn0 == -INFINITY ? 0.f : mn0;   // nothing visible yet
        const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
        const float a0 = exp2_approx(m0 - mu0), a1 = exp2_approx(m1 - mu1);
        m0 = mn0;
        m1 = mn1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float p = exp2_approx(s[j][e] - (e < 2 ? mu0 : mu1));
                if (e < 2) rs0 += p;
                else rs1 += p;
                if constexpr (QUANT) p *= vsc[8 * j + 2 * c + (e & 1)];
                s[j][e] = p;
            }
        }
        l0 = l0 * a0 + rs0;
        l1 = l1 * a1 + rs1;
#pragma unroll
        for (int j = 0; j < OT; ++j) {
            o[j][0] *= a0;
            o[j][1] *= a0;
            o[j][2] *= a1;
            o[j][3] *= a1;
        }

        // O += bf16(P) . V: score n-tiles 2kk and 2kk+1 are the A fragment
        // of k-step kk as they lie
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                    pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                    pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                    pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int d = 0; d < OT / 2; ++d) {
                uint32_t b[4];
                ldsm_x4_trans(sv + tile_off<HD>(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                2 * d + (lane >> 4)), b);
                mma_bf16(o[2 * d], pa, b[0], b[1]);
                mma_bf16(o[2 * d + 1], pa, b[2], b[3]);
            }
        }
    }

    // out = O / l, rounded once; rows past S write nothing
    const float l[2] = {quad_sum(l0), quad_sum(l1)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        const int t = t0 + r / group;
        if (t >= S) continue;
        __nv_bfloat16* dst = out + (static_cast<size_t>(t) * H + kvh * group + r % group) * HD + 2 * c;
#pragma unroll
        for (int j = 0; j < OT; ++j) {
            const float y0 = l[h] > 0.f ? __fdiv_rn(o[j][2 * h], l[h]) : 0.f;
            const float y1 = l[h] > 0.f ? __fdiv_rn(o[j][2 * h + 1], l[h]) : 0.f;
            *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(y0, y1);
        }
    }
}

template <int HD, bool QUANT>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           void* out, int S, int H, int n_kv, int n_ctx, int pos_offset, float sm_scale,
           int window, cudaStream_t s) {
    constexpr int SMEM = Layout<HD, QUANT>::BYTES;
    auto kern = flash_attention_kernel<HD, QUANT>;
    // above 48 KB of dynamic shared memory a kernel must opt in, per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    static unsigned long long configured = 0;        // one bit per device
    if (dev >= 64 || !(configured >> dev & 1ull)) {
        e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (dev < 64) configured |= 1ull << dev;
    }
    const int group = H / n_kv, tpb = BM / group;
    const dim3 grid((S + tpb - 1) / tpb, n_kv);
    kern<<<grid, THREADS, SMEM, s>>>(
        static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<__nv_bfloat16*>(out),
        S, H, n_ctx, group, pos_offset, sm_scale, window);
    return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool QUANT>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             void* out, int S, int H, int n_kv, int n_ctx, int hd, int pos_offset,
             float sm_scale, int window, void* stream) {
    if (S <= 0) return 0;
    if (n_kv <= 0 || H % n_kv != 0 || BM % (H / n_kv) != 0) return 1;
    if (pos_offset < 0 || pos_offset + S > n_ctx) return 1;
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out)) return 1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (hd == 128)
        return launch<128, QUANT>(q, k, v, ks, vs, out, S, H, n_kv, n_ctx, pos_offset, sm_scale,
                                  window, s);
    if (hd == 64)
        return launch<64, QUANT>(q, k, v, ks, vs, out, S, H, n_kv, n_ctx, pos_offset, sm_scale,
                                 window, s);
    return 1;
}

}  // namespace

// Both return cudaErrorInvalidValue (1) for a geometry the kernel does not
// take: HD must be 64 or 128, the GQA group must divide 64, the positions
// must lie in the ring and q, k, v and out must be 16-byte aligned.
LFKT_API int lfkt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  int S, int H, int n_kv, int n_ctx, int hd,
                                  int pos_offset, float sm_scale, int window,
                                  void* stream) {
    return dispatch<false>(q, k, v, nullptr, nullptr, out, S, H, n_kv, n_ctx, hd,
                           pos_offset, sm_scale, window, stream);
}

LFKT_API int lfkt_flash_attention_int8(const void* q, const void* kq, const void* vq,
                                       const void* ks, const void* vs, void* out,
                                       int S, int H, int n_kv, int n_ctx, int hd,
                                       int pos_offset, float sm_scale, int window,
                                       void* stream) {
    return dispatch<true>(q, kq, vq, ks, vs, out, S, H, n_kv, n_ctx, hd, pos_offset,
                          sm_scale, window, stream);
}
