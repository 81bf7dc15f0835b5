// Int8 KV write-quantize: the S new tokens' K and V of one layer, straight
// into that layer's int8 ring.
//   k, v   (S, n_kv, HD)     bf16  the new keys (after RoPE) and values,
//                                  token-major (the model's layout)
//   kq, vq (n_kv, n_ctx, HD) int8  the layer's value rings
//   ks, vs (n_kv, n_ctx)     f32   the layer's per-head per-token scales
// Row (token t, head h) lands in slot pos_offset + t of head h:
//   s = max|x| / 127 over HD, inv = s > 0 ? 1/s : 0,
//   q = clip(round_half_even(x * inv), -127, 127); an all-zero row stores 0s.
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/kvquant.py::_kvq_kernel
// (quantize_kv_pallas), plus the four dynamic_update_slice writes that
// follow it in the JAX model (models/llama.py, the int8 branch of _layer):
// one launch per layer quantizes K and V and writes values and scales into
// the ring in place.
//
// Bit-exactness with the reference's XLA formulation (quantize_kv_xla):
// the division and the reciprocal are IEEE-rounded (__fdiv_rn, __frcp_rn),
// the product x * inv is rounded on its own (__fmul_rn), and rintf rounds
// half to even as jnp.round does (roundf would round half away from zero).
// Built without --use_fast_math.  The arithmetic lives in common.cuh
// (kv_row_scale, kv_quantize_value), shared with decode_loop.cu's ring
// write.
//
// Bound on the H100: bytes, and tiny ones (decode: 2 x 8 rows of 128 bf16 a
// layer).  Design: one warp per (token, head) row of K or V, 8 rows per
// block; a lane holds HD/32 elements, a warp max gives the scale, one pass
// writes the row.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
kv_quantize_kernel(const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   int8_t* __restrict__ kq, int8_t* __restrict__ vq,
                   float* __restrict__ ks, float* __restrict__ vs,
                   int S, int n_kv, int n_ctx, int hd, int pos_offset) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);   // over 2 * S * n_kv
    const int rows = S * n_kv;
    if (row >= 2 * rows) return;
    const bool is_v = row >= rows;
    const int r = is_v ? row - rows : row;                     // = t * n_kv + h
    const int t = r / n_kv, h = r % n_kv;
    const __nv_bfloat16* x = (is_v ? v : k) + static_cast<size_t>(r) * hd;
    const size_t slot = static_cast<size_t>(h) * n_ctx + pos_offset + t;
    int8_t* q = (is_v ? vq : kq) + slot * hd;

    float amax = 0.f;
    for (int d = lane; d < hd; d += 32) amax = fmaxf(amax, fabsf(__bfloat162float(x[d])));
    float inv;
    const float s = lfkt::kv_row_scale(amax, inv);
    for (int d = lane; d < hd; d += 32)
        q[d] = lfkt::kv_quantize_value(__bfloat162float(x[d]), inv);
    if (lane == 0) (is_v ? vs : ks)[slot] = s;
}

}  // namespace

LFKT_API int lfkt_kv_quantize(const void* k, const void* v, void* kq, void* vq,
                              void* ks, void* vs, int S, int n_kv, int n_ctx, int hd,
                              int pos_offset, void* stream) {
    if (S <= 0) return 0;
    if (n_kv <= 0 || hd <= 0 || pos_offset < 0 || pos_offset + S > n_ctx) return 1;
    const int rows = 2 * S * n_kv;
    kv_quantize_kernel<<<(rows + WARPS - 1) / WARPS, WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
        static_cast<int8_t*>(kq), static_cast<int8_t*>(vq), static_cast<float*>(ks),
        static_cast<float*>(vs), S, n_kv, n_ctx, hd, pos_offset);
    return static_cast<int>(cudaGetLastError());
}
