// Int8 KV write: the S new tokens' K (rotated here) and V of one layer,
// quantized straight into that layer's int8 ring.
//   k, v     (S, n_kv, HD)     bf16  the new keys (before RoPE) and values,
//                                    token-major (the model's layout)
//   cos, sin (S, HD/2)         f32   the pass's rotation table: row t holds
//                                    the angles of token t (position
//                                    positions[t]); ops/rope.py builds it
//                                    once a forward pass
//   positions (S)              int64 the pass's ring slots, in device memory
//   kq, vq   (n_kv, n_ctx, HD) int8  the layer's value rings
//   ks, vs   (n_kv, n_ctx)     f32   the layer's per-head per-token scales
//   lane_stride                      slots between the rings of two tokens
// Row (token t, head h) lands in slot positions[t] of head h of ring t:
// scale index t * lane_stride + h * n_ctx + positions[t], value index that
// times HD.  lane_stride 0 is one ring for every token (a prompt pass); a
// lane step passes one token a lane, each lane's slot, and the lane ring's
// slot count (L * n_kv * n_ctx in the lane-major (B, L, n_kv, n_ctx, HD)
// layout), so the B lanes' writes take one launch a layer.  The slots are
// read on the device, never passed by value, so a decode step captured in a
// CUDA graph writes wherever the step's position tensor points at replay
// (the caller checks the range on its host mirror; a slot outside the ring
// is skipped, never written).  A K row is
// first rotated: pairs (2i, 2i+1) by the table's angle i, rounded to bf16
// (rope_pair).  Then, over the row's HD (rotated) values:
//   s = max|x| / 127, inv = s > 0 ? 1/s : 0,
//   q = clip(round_half_even(x * inv), -127, 127); an all-zero row stores 0s.
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/kvquant.py::_kvq_kernel
// (quantize_kv_pallas), plus what surrounds it in the int8 branch of the
// JAX model's _layer (models/llama.py): rope_interleaved on k before it and
// the four dynamic_update_slice writes after it.  One launch per layer
// rotates K, quantizes K and V, and writes values and scales into the ring
// in place, where the plain torch before it took 13 small launches a layer
// for the table and k's rotation.
//
// Bit-exactness with the plain path (rope_rotate, then quantize_kv_plain):
// the rotation's products and sum are IEEE-rounded one by one and the
// result rounded to bf16 before the max (lfkt::rope_pair); the angles come
// from the table, never from cosf here.  The quantize is the reference's
// quantize_kv_xla: __fdiv_rn, __frcp_rn, __fmul_rn and rintf (half to even)
// in lfkt::kv_row_scale / kv_quantize_value, shared with decode_loop.cu's
// ring write.  Built without --use_fast_math.
//
// Bound on the H100: bytes, and tiny ones (decode: 2 x 8 rows of 128 bf16
// and 64 angles a layer); a launch is latency.  Design: one warp per
// (token, head) row of K or V, 8 rows per block.  Lane l owns the
// contiguous elements [l*HD/32, (l+1)*HD/32): at HD=128 two whole pairs
// from one 8-byte load, and their two angles from one 8-byte load of each
// table row; at HD=64 one pair.  A warp max gives the scale, and each lane
// writes its codes as one 4-byte (2-byte) store.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

template <int HD> struct Lane;
template <> struct Lane<128> {                 // 4 elements: 8 bytes in, 4 out
    using In = uint2;
    using Out = uint32_t;
};
template <> struct Lane<64> {                  // 2 elements: 4 bytes in, 2 out
    using In = uint32_t;
    using Out = uint16_t;
};

using lfkt::hi_bf;
using lfkt::lo_bf;

__device__ __forceinline__ void unpack(uint2 u, float* x) {
    x[0] = lo_bf(u.x); x[1] = hi_bf(u.x); x[2] = lo_bf(u.y); x[3] = hi_bf(u.y);
}
__device__ __forceinline__ void unpack(uint32_t u, float* x) { x[0] = lo_bf(u); x[1] = hi_bf(u); }

template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
kv_quantize_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                   const long long* __restrict__ positions,
                   int8_t* __restrict__ kq, int8_t* __restrict__ vq,
                   float* __restrict__ ks, float* __restrict__ vs,
                   int S, int n_kv, int n_ctx, long long lane_stride) {
    constexpr int E = HD / 32;                                 // elements a lane
    using In = typename Lane<HD>::In;
    using Out = typename Lane<HD>::Out;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);   // over 2 * S * n_kv
    const int rows = S * n_kv;
    if (row >= 2 * rows) return;
    const bool is_v = row >= rows;
    const int r = is_v ? row - rows : row;                     // = t * n_kv + h
    const int t = r / n_kv, h = r % n_kv;
    const long long pos = positions[t];
    if (pos < 0 || pos >= n_ctx) return;                       // uniform over the warp

    float x[E];
    unpack(*reinterpret_cast<const In*>((is_v ? v : k) + static_cast<size_t>(r) * HD + lane * E),
           x);
    if (!is_v) {
        const size_t a = static_cast<size_t>(t) * (HD / 2) + lane * (E / 2);
#pragma unroll
        for (int p = 0; p < E / 2; ++p)
            lfkt::rope_pair(x[2 * p], x[2 * p + 1], cos_t[a + p], sin_t[a + p], x[2 * p],
                            x[2 * p + 1]);
    }
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(x[e]));
    float inv;
    const float s = lfkt::kv_row_scale(amax, inv);
    Out codes = 0;
#pragma unroll
    for (int e = 0; e < E; ++e)
        codes |= static_cast<Out>(static_cast<uint8_t>(lfkt::kv_quantize_value(x[e], inv)))
                 << (8 * e);
    const size_t slot = static_cast<size_t>(t) * static_cast<size_t>(lane_stride) +
                        static_cast<size_t>(h) * n_ctx + static_cast<size_t>(pos);
    *reinterpret_cast<Out*>((is_v ? vq : kq) + slot * HD + lane * E) = codes;
    if (lane == 0) (is_v ? vs : ks)[slot] = s;
}

template <int HD>
void launch(const void* k, const void* v, const void* cos_t, const void* sin_t,
            const void* positions, void* kq, void* vq, void* ks, void* vs, int S, int n_kv,
            int n_ctx, long long lane_stride, cudaStream_t stream) {
    const int rows = 2 * S * n_kv;
    kv_quantize_kernel<HD><<<(rows + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
        static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
        static_cast<const long long*>(positions), static_cast<int8_t*>(kq), static_cast<int8_t*>(vq), static_cast<float*>(ks),
        static_cast<float*>(vs), S, n_kv, n_ctx, lane_stride);
}

}  // namespace

LFKT_API int lfkt_kv_quantize(const void* k, const void* v, const void* cos_t,
                              const void* sin_t, const void* positions, void* kq, void* vq,
                              void* ks, void* vs, int S, int n_kv, int n_ctx, int hd,
                              long long lane_stride, void* stream) {
    if (S <= 0) return 0;
    if (n_kv <= 0 || n_ctx <= 0 || positions == nullptr || lane_stride < 0) return 1;
    auto st = static_cast<cudaStream_t>(stream);
    if (hd == 128)
        launch<128>(k, v, cos_t, sin_t, positions, kq, vq, ks, vs, S, n_kv, n_ctx, lane_stride,
                    st);
    else if (hd == 64)
        launch<64>(k, v, cos_t, sin_t, positions, kq, vq, ks, vs, S, n_kv, n_ctx, lane_stride,
                   st);
    else
        return 1;
    return static_cast<int>(cudaGetLastError());
}
