// Causal (+ optional sliding-window) GQA flash attention of S new queries
// over one layer's head-major KV ring, at cache offset pos_offset.
//   q   (S, H, HD)       bf16   queries, token-major (the model's layout)
//   k,v (n_kv, n_ctx, HD) bf16  the ring; slots past pos_offset+S may hold
//                               stale data and are hidden by the causal mask
//   out (S, H, HD)       bf16
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/attention.py::_attn_kernel
// (flash_attention), bf16 branch.  As there, the `group = H / n_kv` query
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
// in shared memory (rows padded to HD+2 bf16 so lane j's K row and its
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

template <int HD>
__global__ void __launch_bounds__(ROWS * 32)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out,
                       int S, int H, int n_ctx, int group, int pos_offset,
                       float sm_scale, int window) {
    constexpr int KS = HD + 2;                 // padded K/V row (bf16)
    constexpr int DPL = HD / 32;               // output dims per lane
    extern __shared__ __align__(16) unsigned char smem[];
    float* qs = reinterpret_cast<float*>(smem);                      // [ROWS][HD]
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(qs + ROWS * HD);  // [BK][KS]
    __nv_bfloat16* vs = ks + BK * KS;                                 // [BK][KS]

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

    const __nv_bfloat16* kh = k + static_cast<size_t>(kvh) * n_ctx * HD;
    const __nv_bfloat16* vh = v + static_cast<size_t>(kvh) * n_ctx * HD;
    float m = -INFINITY, l = 0.f;
    float acc[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

    for (int kb = key_begin; kb < key_end; kb += BK) {
        __syncthreads();
        // stage the tile: BK rows of HD bf16, 2 bf16 (one word) per step
        for (int i = threadIdx.x; i < BK * HD / 2; i += ROWS * 32) {
            const int r = i / (HD / 2), c = (i % (HD / 2)) * 2;
            const int key = kb + r;
            uint32_t kw = 0, vw = 0;
            if (key < n_ctx) {
                kw = *reinterpret_cast<const uint32_t*>(kh + static_cast<size_t>(key) * HD + c);
                vw = *reinterpret_cast<const uint32_t*>(vh + static_cast<size_t>(key) * HD + c);
            }
            *reinterpret_cast<uint32_t*>(ks + r * KS + c) = kw;
            *reinterpret_cast<uint32_t*>(vs + r * KS + c) = vw;
        }
        __syncthreads();
        if (!valid) continue;

        const int key = kb + lane;
        bool vis = key < key_end && key <= q_pos;
        if (window > 0) vis = vis && key > q_pos - window;
        float s = -INFINITY;
        if (vis) {
            const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(ks + lane * KS);
            const float* qr = qs + warp * HD;
            float dot = 0.f;
#pragma unroll 16
            for (int d = 0; d < HD / 2; ++d) {
                const float2 kf = __bfloat1622float2(kr[d]);
                dot = fmaf(qr[2 * d], kf.x, dot);
                dot = fmaf(qr[2 * d + 1], kf.y, dot);
            }
            s = dot * sm_scale;
        }
        const float m_tile = lfkt::warp_max(s);
        if (m_tile == -INFINITY) continue;         // nothing visible for this row
        const float m_new = fmaxf(m, m_tile);
        const float alpha = __expf(m - m_new);     // m = -inf on the first tile -> 0
        const float p = vis ? __expf(s - m_new) : 0.f;
        l = l * alpha + lfkt::warp_sum(p);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
        for (int j = 0; j < BK; ++j) {
            const float pj = __shfl_sync(0xffffffffu, p, j);
            if (pj == 0.f) continue;               // warp-uniform: pj is broadcast
            const __nv_bfloat16* vr = vs + j * KS + lane * DPL;
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[i] = fmaf(pj, __bfloat162float(vr[i]), acc[i]);
        }
        m = m_new;
    }
    if (!valid) return;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* orow = out + (static_cast<size_t>(tok) * H + head) * HD + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[i] = __float2bfloat16_rn(acc[i] * inv);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int S, int H,
           int n_kv, int n_ctx, int pos_offset, float sm_scale, int window,
           cudaStream_t s) {
    const int group = H / n_kv;
    const int tpb = ROWS / group;
    const size_t smem = sizeof(float) * ROWS * HD + 2 * sizeof(__nv_bfloat16) * BK * (HD + 2);
    dim3 grid((S + tpb - 1) / tpb, n_kv);
    flash_attention_kernel<HD><<<grid, ROWS * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        S, H, n_ctx, group, pos_offset, sm_scale, window);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaErrorInvalidValue (1) for a geometry the kernel does not take:
// HD must be 64 or 128 and the GQA group must divide 16.
LFKT_API int lfkt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  int S, int H, int n_kv, int n_ctx, int hd,
                                  int pos_offset, float sm_scale, int window,
                                  void* stream) {
    if (S <= 0) return 0;
    if (n_kv <= 0 || H % n_kv != 0 || ROWS % (H / n_kv) != 0) return 1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (hd == 128) return launch<128>(q, k, v, out, S, H, n_kv, n_ctx, pos_offset, sm_scale, window, s);
    if (hd == 64) return launch<64>(q, k, v, out, S, H, n_kv, n_ctx, pos_offset, sm_scale, window, s);
    return 1;
}
