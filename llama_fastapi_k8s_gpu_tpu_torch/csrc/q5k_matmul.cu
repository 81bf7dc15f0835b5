// Fused Q5_K dequant-matmul: y (B, N) bf16 = x (B, K) bf16 . W^T, with W
// (N, K) held as its raw GGUF Q5_K blocks (176 bytes per 256 weights), one
// row of K/256 blocks per output feature.  f32 accumulation, bf16 out.
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/q5matmul.py::
// _q5k_pre_kernel (the JAX default layout) and _q5k_matmul_kernel (the
// `cur` split layout).  Both compute one function from two TPU repacks of
// the same blocks (a pre-combined int8 plane, or nibble and hi-bit planes,
// with bf16-folded scales and correction columns); this kernel decodes the
// file's own bytes in registers, so loading a weight is an upload.  Element
// i of sub-block j is q = nibble(qs[(j/2)*32 + i], high if j odd)
// + 16*((qh[i] >> j) & 1), and w = d*sc[j]*q - dmin*mn[j] with d*sc and
// dmin*mn exact in f32.
//
// Bound on the H100: bytes at decode (B = 1: ~5.5 bits/weight read once,
// 2 flops/weight), operations at prefill (B = 256).  Two paths, chosen by
// B alone (qmma_route.cu):
//   - B >= the route's threshold (every prompt pass): the tensor-core
//     template of qmma.cuh with the Q5_K decoder below, which turns 32
//     weights of a staged block into bf16 — each the f32 codec's value
//     rounded once, so the product is the bf16 plane's;
//   - below it (decode): the CUDA-core path of qgemv.cuh with the Q5_K
//     unit decoder below (Q5KGemv), Q4_K's unit plus the high-bit plane:
//     lane l takes the 16-byte header, the 32 bytes of qh and the 32-byte
//     qs run c = l % 4 of a super-block (weights 0..31 of sub-blocks 2c
//     and 2c + 1), so a warp step is 8 super-blocks of a row; per
//     16-element segment acc += d*sc*sum(q*x) - dmin*mn*sum(x), the scales
//     exact in f32.
#include "qgemv.cuh"
#include "qmma.cuh"

namespace {

// Weights 32c..32c+31 (sub-block j = c) of the Q5_K block at `blk` (16-byte
// aligned in shared memory) as 16 bf16 pairs: q = nibble + 16*hibit from
// two 32-byte runs (qs, qh), w = d*sc*q - dmin*mn rounded in f32 as the
// codec rounds it (d*sc*q is exact, so one fused multiply-add rounds as
// its multiply and subtract do), then to bf16.
struct Q5KDecoder {
    static constexpr int BLOCK = lfkt::Q5K_BLOCK;
    static constexpr int SLOT = 176;         // an odd number of 16-byte chunks
    static __device__ __forceinline__ void decode32(const uint8_t* blk, int j,
                                                    uint32_t (&out)[16]) {
        const float d = lfkt::f16_at(blk);
        const float dmin = lfkt::f16_at(blk + 2);
        int sc, mn;
        lfkt::scale_min_k4(blk + 4, j, sc, mn);
        const float scale = d * static_cast<float>(sc);
        const float minv = dmin * static_cast<float>(mn);
        const uint4* qs4 = reinterpret_cast<const uint4*>(blk + 48 + (j >> 1) * 32);
        const uint4* qh4 = reinterpret_cast<const uint4*>(blk + 16);
        const uint4 s0 = qs4[0], s1 = qs4[1], h0 = qh4[0], h1 = qh4[1];
        const uint32_t qs[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const uint32_t qh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
        const int nsh = (j & 1) * 4;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const uint32_t q = ((qs[i] >> nsh) & 0x0F0F0F0Fu) | (((qh[i] >> j) & 0x01010101u) << 4);
            float f[4];
#pragma unroll
            for (int b = 0; b < 4; ++b)
                f[b] = __fmaf_rn(scale, __fsub_rn(lfkt::qmma::byte_f(q, b), 8388608.0f), -minv);
            out[2 * i] = lfkt::qmma::pack_bf16(f[0], f[1]);
            out[2 * i + 1] = lfkt::qmma::pack_bf16(f[2], f[3]);
        }
    }
};

// The decode path's unit: Q4KGemv's (q4k_matmul.cu) plus the high bits.
// Lane l of a step holds the 16-byte header, the block's 32 bytes of qh
// (the four lanes of a super-block load the same bytes: one broadcast in
// the warp's load) and the 32-byte qs run c = l % 4 of super-block
// 8s + l / 4 — weights 0..31 of sub-blocks 2c (low nibbles) and 2c + 1
// (high nibbles) — as segments g = 0..3: sub-block j = 2c + (g & 1),
// elements 16 * (g >> 1) .. + 16.  Bit j of qh byte i is the high bit of
// element i of sub-block j.  A lane past the row's last super-block (a
// partial last step) gets scale and min 0.
struct Q5KGemv {
    static constexpr int ELEMS = lfkt::QK_K, BYTES = lfkt::Q5K_BLOCK;
    static constexpr int STEP = 8 * lfkt::QK_K;   // 8 super-blocks: 1,408 bytes a row
    static constexpr int SEGS = 4;
    static constexpr bool MIN = true;
    static constexpr float Q0 = 0.5f;             // q handed out as 0.5 + q / 256
    static constexpr int XSW = 4;                 // a lane's x run: 2^XSW 16-byte chunks
    static constexpr int STAGE = 0;               // no exchange
    static constexpr int AHEAD = 2;
    static constexpr bool REFILL_EARLY = false;   // segment() reads the raw qs and qh
    struct RawQ { uint32_t h[4], qh[8], q[8]; };
    template <bool A16> using Raw = RawQ;
    // rot: the rotation that brings bit 2c of a qh byte to bit 4
    struct Unit { float a[2], m[2]; uint32_t rot; };

    static __device__ __forceinline__ int sb(int s, int lane) { return s * 8 + (lane >> 2); }
    static __device__ __forceinline__ bool valid(int s, int lane, int K) {
        return sb(s, lane) < K / lfkt::QK_K;
    }
    static __device__ __forceinline__ int x_offset(int s, int lane, int g, int K) {
        return valid(s, lane, K)
            ? sb(s, lane) * lfkt::QK_K + (2 * (lane & 3) + (g & 1)) * 32 + (g >> 1) * 16 : 0;
    }
    // 16-byte loads (176-byte blocks keep every part 16-byte aligned), or
    // 8-byte ones (the wrapper's alignment)
    template <bool A16>
    static __device__ __forceinline__ void load(RawQ& r, const uint8_t* row, int s, int lane,
                                                int K) {
        if (!valid(s, lane, K)) return;
        const uint8_t* blk = row + static_cast<size_t>(sb(s, lane)) * lfkt::Q5K_BLOCK;
        const uint8_t* qs = blk + 48 + (lane & 3) * 32;
        if constexpr (A16) {
            const uint4 h = lfkt::qgemv::ld_stream16(blk);
            const uint4 b0 = lfkt::qgemv::ld_stream16(blk + 16), b1 = lfkt::qgemv::ld_stream16(blk + 32);
            const uint4 a = lfkt::qgemv::ld_stream16(qs), b = lfkt::qgemv::ld_stream16(qs + 16);
            r.h[0] = h.x; r.h[1] = h.y; r.h[2] = h.z; r.h[3] = h.w;
            r.qh[0] = b0.x; r.qh[1] = b0.y; r.qh[2] = b0.z; r.qh[3] = b0.w;
            r.qh[4] = b1.x; r.qh[5] = b1.y; r.qh[6] = b1.z; r.qh[7] = b1.w;
            r.q[0] = a.x; r.q[1] = a.y; r.q[2] = a.z; r.q[3] = a.w;
            r.q[4] = b.x; r.q[5] = b.y; r.q[6] = b.z; r.q[7] = b.w;
        } else {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const uint2 v = lfkt::qgemv::ld_stream8(blk + 8 * i);
                r.h[2 * i] = v.x;
                r.h[2 * i + 1] = v.y;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const uint2 v = lfkt::qgemv::ld_stream8(blk + 16 + 8 * i);
                const uint2 u = lfkt::qgemv::ld_stream8(qs + 8 * i);
                r.qh[2 * i] = v.x;
                r.qh[2 * i + 1] = v.y;
                r.q[2 * i] = u.x;
                r.q[2 * i + 1] = u.y;
            }
        }
    }
    // scales 256*d*sc (for q handed out / 256) and mins dmin*mn of
    // sub-blocks j = 2c, 2c + 1 from the header, as Q4KGemv takes them:
    // bytes j & 3 and (j & 3) + 1 of the packed words s[0..3], s[4..7],
    // s[8..11]
    template <bool A16>
    static __device__ __forceinline__ void unpack(const RawQ (&r)[lfkt::qgemv::NR],
                                                  Unit (&u)[lfkt::qgemv::NR], int lane,
                                                  uint8_t*, int s, int K) {
        const int c = lane & 3;
        const uint32_t sel = (c & 1) ? 0x4432u : 0x4410u;
        const bool ok = valid(s, lane, K);
#pragma unroll
        for (int n = 0; n < lfkt::qgemv::NR; ++n) {
            const float d = ok ? __half2float(__ushort_as_half(
                static_cast<unsigned short>(r[n].h[0] & 0xFFFFu))) : 0.f;
            const float dmin = ok ? __half2float(__ushort_as_half(
                static_cast<unsigned short>(r[n].h[0] >> 16))) : 0.f;
            const uint32_t lo = __byte_perm(r[n].h[1], 0, sel);    // s[j & 3]
            const uint32_t mid = __byte_perm(r[n].h[2], 0, sel);   // s[(j & 3) + 4]
            const uint32_t hi = __byte_perm(r[n].h[3], 0, sel);    // s[(j & 3) + 8]
            const uint32_t sc = c < 2 ? (lo & 0x3F3Fu)
                                      : ((hi & 0x0F0Fu) | ((lo >> 2) & 0x3030u));
            const uint32_t mn = c < 2 ? (mid & 0x3F3Fu)
                                      : (((hi >> 4) & 0x0F0Fu) | ((mid >> 2) & 0x3030u));
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                u[n].a[e] = (d * static_cast<float>((sc >> (8 * e)) & 0xFFu)) * 256.f;
                u[n].m[e] = dmin * static_cast<float>((mn >> (8 * e)) & 0xFFu);
            }
            // right by 2c - 4, mod 32: bit 2c of a byte lands on its bit 4
            // (2c < 4: a left rotation, which keeps it in its byte too)
            u[n].rot = static_cast<uint32_t>(28 + 2 * c);
        }
    }
    // segment g's 16 weights as 0.5 + q / 256, exactly: the nibble and,
    // rotated into bit 4, the high bit j = 2c + (g & 1) make the byte q,
    // placed in bits 16..23 under 0x3F (sign 0, exponent 2^-1) by one byte
    // permute, with no subtraction
    static __device__ __forceinline__ void segment(const Unit& u, const RawQ& r, int g,
                                                   float (&q)[16], float& a, float& m) {
        const int half = g >> 1, hi = g & 1;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t h = r.qh[4 * half + i];
            const uint32_t v = ((r.q[4 * half + i] >> (4 * hi)) & 0x0F0F0F0Fu) |
                               (__funnelshift_r(h, h, u.rot + hi) & 0x10101010u);
#pragma unroll
            for (int b = 0; b < 4; ++b)
                q[4 * i + b] = __uint_as_float(__byte_perm(v, 0x3F000000u, 0x7044u | (b << 8)));
        }
        a = u.a[hi];
        m = u.m[hi];
    }
};

}  // namespace

LFKT_API int lfkt_q5k_matmul(const void* x, const void* w, void* y, int B, int N,
                             int K, void* stream) {
    if (B <= 0 || N <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (lfkt::qmma::use_tc(lfkt::qmma::FMT_Q5K, B, K))
        return lfkt::qmma::launch<Q5KDecoder>(x, w, y, B, N, K, s);
    return lfkt::qgemv::launch<Q5KGemv>(x, w, y, B, N, K, s);
}
