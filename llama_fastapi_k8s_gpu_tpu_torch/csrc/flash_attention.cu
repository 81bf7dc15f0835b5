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
// (flash_attention), both branches: the kernel is templated on the K/V
// element type.  The int8 branch is the reference's scale-last form: the
// raw int8 tile is staged (half the bf16 bytes) with its keys' scales
// beside it, score = (q . k_int8) * sm_scale * ks[key], and vs[key] is
// folded into the key's probability before P.V, so no bf16 ring is ever
// materialized.  As there, the `group = H / n_kv` query
// heads sharing one KV head are folded into one block's rows, so each K/V
// tile fetched from memory serves all of them; the softmax is online in
// f32 and K/V tiles wholly in the masked future are never visited.  Unlike
// the TPU grid, blocks run in parallel with no carried scratch: each block
// loops over its own KV tiles.
//
// Bound on the H100: at prefill (S = 256) operations — 4*S*keys*HD flops
// per head against 2*keys*HD*2 bytes of K/V per KV head; at the main
// path's sizes the work is small (a few GFLOP per layer).  First, simple
// design on CUDA cores: a block of 16 warps, one warp per (token, head)
// row, 16/group tokens per block; per 32-key tile the block stages K and V
// in shared memory (rows padded by one 32-bit word so lane j's K row and its
// neighbours' fall in distinct banks); lane j scores key j against the
// row's query (held in shared memory as f32), the warp runs the online
// softmax update, then each lane accumulates HD/32 output dims of P.V with
// the probabilities broadcast by shuffles.  Scores use -inf for masked keys
// and every row's update is skipped on a tile where all its keys are
// masked, so a row never sees exp(-inf - -inf); a row with no visible key
// at all writes zeros, not NaN.  Tensor cores (mma/wgmma) are the next
// step.
#include "common.cuh"

namespace {

constexpr int ROWS = 16;      // warps (query rows) per block
constexpr int BK = 32;        // keys per tile = one per lane

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// T is __nv_bfloat16 (plain ring) or int8_t (quantized ring, scales in ks/vs)
template <int HD, typename T>
__global__ void __launch_bounds__(ROWS * 32)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       __nv_bfloat16* __restrict__ out,
                       int S, int H, int n_ctx, int group, int pos_offset,
                       float sm_scale, int window) {
    constexpr bool QUANT = sizeof(T) == 1;
    constexpr int WPR = HD * static_cast<int>(sizeof(T)) / 4;   // 32-bit words per K/V row
    constexpr int KSW = WPR + 1;                                // padded row (words)
    constexpr int DPL = HD / 32;                                // output dims per lane
    extern __shared__ __align__(16) unsigned char smem[];
    float* qs = reinterpret_cast<float*>(smem);                  // [ROWS][HD]
    uint32_t* kt = reinterpret_cast<uint32_t*>(qs + ROWS * HD);  // [BK][KSW]
    uint32_t* vt = kt + BK * KSW;                                // [BK][KSW]
    float* ksc = reinterpret_cast<float*>(vt + BK * KSW);        // [BK] (int8 only)
    float* vsc = ksc + BK;                                       // [BK]

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int tpb = ROWS / group;              // tokens per block
    const int kvh = blockIdx.y;
    const int t0 = blockIdx.x * tpb;
    const int tok = t0 + warp / group;
    const int head = kvh * group + warp % group;
    const bool valid = tok < S;
    const int q_pos = pos_offset + tok;

    // the block's query span decides which KV tiles it visits (uniform)
    const int t_last = min(t0 + tpb, S) - 1;
    const int q_max = pos_offset + t_last;
    const int key_end = min(n_ctx, q_max + 1);
    int key_begin = 0;
    if (window > 0) key_begin = max(0, pos_offset + t0 - window + 1) / BK * BK;

    if (valid) {
        const __nv_bfloat16* qrow = q + (static_cast<size_t>(tok) * H + head) * HD;
        for (int d = lane; d < HD; d += 32) qs[warp * HD + d] = __bfloat162float(qrow[d]);
    }
    __syncwarp();

    const uint32_t* kh = reinterpret_cast<const uint32_t*>(k + static_cast<size_t>(kvh) * n_ctx * HD);
    const uint32_t* vh = reinterpret_cast<const uint32_t*>(v + static_cast<size_t>(kvh) * n_ctx * HD);
    float m = -INFINITY, l = 0.f;
    float acc[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

    for (int kb = key_begin; kb < key_end; kb += BK) {
        __syncthreads();
        // stage the tile: BK rows of WPR words each (2 bf16 or 4 int8 a word)
        for (int i = threadIdx.x; i < BK * WPR; i += ROWS * 32) {
            const int r = i / WPR, c = i % WPR;
            const int key = kb + r;
            uint32_t kw = 0, vw = 0;
            if (key < n_ctx) {
                kw = kh[static_cast<size_t>(key) * WPR + c];
                vw = vh[static_cast<size_t>(key) * WPR + c];
            }
            kt[r * KSW + c] = kw;
            vt[r * KSW + c] = vw;
        }
        if constexpr (QUANT) {
            const int r = threadIdx.x & (BK - 1);
            const int key = kb + r;
            if (threadIdx.x < BK) ksc[r] = key < n_ctx ? ks[static_cast<size_t>(kvh) * n_ctx + key] : 0.f;
            else if (threadIdx.x < 2 * BK) vsc[r] = key < n_ctx ? vs[static_cast<size_t>(kvh) * n_ctx + key] : 0.f;
        }
        __syncthreads();
        if (!valid) continue;

        const int key = kb + lane;
        bool vis = key < key_end && key <= q_pos;
        if (window > 0) vis = vis && key > q_pos - window;
        float s = -INFINITY;
        if (vis) {
            const float* qr = qs + warp * HD;
            float dot = 0.f;
            if constexpr (QUANT) {
                const uint32_t* kr = kt + lane * KSW;
#pragma unroll 8
                for (int w = 0; w < WPR; ++w) {
                    const uint32_t word = kr[w];
#pragma unroll
                    for (int b = 0; b < 4; ++b)
                        dot = fmaf(qr[4 * w + b], static_cast<float>(static_cast<int8_t>(word >> (8 * b))), dot);
                }
                s = dot * sm_scale * ksc[lane];
            } else {
                const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(kt + lane * KSW);
#pragma unroll 16
                for (int d = 0; d < HD / 2; ++d) {
                    const float2 kf = __bfloat1622float2(kr[d]);
                    dot = fmaf(qr[2 * d], kf.x, dot);
                    dot = fmaf(qr[2 * d + 1], kf.y, dot);
                }
                s = dot * sm_scale;
            }
        }
        const float m_tile = lfkt::warp_max(s);
        if (m_tile == -INFINITY) continue;         // nothing visible for this row
        const float m_new = fmaxf(m, m_tile);
        const float alpha = __expf(m - m_new);     // m = -inf on the first tile -> 0
        const float p = vis ? __expf(s - m_new) : 0.f;
        l = l * alpha + lfkt::warp_sum(p);
        // the value scale folds into the key's probability: p.(q.s) == (p.s).q
        const float pv = QUANT ? p * vsc[lane] : p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
        for (int j = 0; j < BK; ++j) {
            const float pj = __shfl_sync(0xffffffffu, pv, j);
            if (pj == 0.f) continue;               // warp-uniform: pj is broadcast
            const T* vr = reinterpret_cast<const T*>(vt + j * KSW) + lane * DPL;
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[i] = fmaf(pj, to_f32(vr[i]), acc[i]);
        }
        m = m_new;
    }
    if (!valid) return;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* orow = out + (static_cast<size_t>(tok) * H + head) * HD + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[i] = __float2bfloat16_rn(acc[i] * inv);
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           void* out, int S, int H, int n_kv, int n_ctx, int pos_offset, float sm_scale,
           int window, cudaStream_t s) {
    const int group = H / n_kv;
    const int tpb = ROWS / group;
    const int ksw = HD * static_cast<int>(sizeof(T)) / 4 + 1;
    const size_t smem = sizeof(float) * ROWS * HD + 2 * sizeof(uint32_t) * BK * ksw
                        + 2 * sizeof(float) * BK;
    dim3 grid((S + tpb - 1) / tpb, n_kv);
    flash_attention_kernel<HD, T><<<grid, ROWS * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<__nv_bfloat16*>(out),
        S, H, n_ctx, group, pos_offset, sm_scale, window);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             void* out, int S, int H, int n_kv, int n_ctx, int hd, int pos_offset,
             float sm_scale, int window, void* stream) {
    if (S <= 0) return 0;
    if (n_kv <= 0 || H % n_kv != 0 || ROWS % (H / n_kv) != 0) return 1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (hd == 128)
        return launch<128, T>(q, k, v, ks, vs, out, S, H, n_kv, n_ctx, pos_offset, sm_scale, window, s);
    if (hd == 64)
        return launch<64, T>(q, k, v, ks, vs, out, S, H, n_kv, n_ctx, pos_offset, sm_scale, window, s);
    return 1;
}

}  // namespace

// Both return cudaErrorInvalidValue (1) for a geometry the kernel does not
// take: HD must be 64 or 128 and the GQA group must divide 16.
LFKT_API int lfkt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  int S, int H, int n_kv, int n_ctx, int hd,
                                  int pos_offset, float sm_scale, int window,
                                  void* stream) {
    return dispatch<__nv_bfloat16>(q, k, v, nullptr, nullptr, out, S, H, n_kv, n_ctx, hd,
                                   pos_offset, sm_scale, window, stream);
}

LFKT_API int lfkt_flash_attention_int8(const void* q, const void* kq, const void* vq,
                                       const void* ks, const void* vs, void* out,
                                       int S, int H, int n_kv, int n_ctx, int hd,
                                       int pos_offset, float sm_scale, int window,
                                       void* stream) {
    return dispatch<int8_t>(q, kq, vq, ks, vs, out, S, H, n_kv, n_ctx, hd, pos_offset,
                            sm_scale, window, stream);
}
