// Fused Q6_K dequant-matmul: y (B, N) bf16 = x (B, K) bf16 . W^T, with W
// (N, K) held as its raw GGUF Q6_K blocks (210 bytes per 256 weights), one
// row of K/256 blocks per output feature.  f32 accumulation, bf16 out.
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/q6matmul.py::
// _q6k_matmul_kernel (q6k_matmul / q6k_matmul_stacked, default `cur`) and
// _q6k_pre_kernel (the `pre` layout of the same function).  The Pallas
// kernels took a host repack (nibble and crumb planes, element-major
// columns, bf16-folded d*sc and 256 correction columns).  Here the block
// bytes are decoded in registers: q6 = (ql nibble) | (qh crumb << 4),
// w = d * sc[16-element sub-block] * (q6 - 32), with d*sc exact in f32.
//
// Bound on the H100: bytes at decode (~6.6 bits/weight read once per
// token; the 128256 x 4096 output head alone is 431 MB), operations at
// prefill.  Two paths, chosen by B alone (qmma_route.cu): at and above the
// route's threshold (every prompt pass) the tensor-core template of
// qmma.cuh with the Q6_K decoder below; under it (decode) the CUDA-core
// path of qgemv.cuh with the Q6_K unit decoder below (Q6KGemv).  A warp
// step is 8 super-blocks of a row (1,680 bytes, 16-byte aligned where the
// row is: rows of a multiple of 8 blocks, every 8B shape); lane l decodes
// 64 weights of super-block l / 4 — 16 of each quarter of one half, which
// share 16 bytes of each ql run and 16 bytes of qh, so a lane reads 48
// bytes for its 64 weights.  Per 16-element segment acc += d*sc*sum(q6*x)
// - 32*d*sc*sum(x), d*sc exact in f32.
//
// Alignment: a 210-byte block is only 2-byte aligned, so no lane can load
// its own bytes wide.  As for Q8_0 (q8_matmul.cu), the warp loads a step's
// bytes as aligned 16-byte vectors (16-bit words where the row is not
// 16-byte aligned), stores them to a buffer of its own in shared memory
// and each lane reads its runs back as aligned words shifted by 16 bits
// where needed — within the warp (__syncwarp), no block barrier.
#include "qgemv.cuh"
#include "qmma.cuh"

namespace {

// Weights 32c..32c+31 of the Q6_K block at `blk` (2-byte aligned in shared
// memory: a 210-byte block sits at any even offset of its 16-byte span) as
// 16 bf16 pairs.  Chunk c is quarter q = c%4 of half h = c/4: its ql run
// (32 bytes, low nibbles for q < 2), its qh run (the half's 32 bytes, crumb
// q) and two 16-element scales; w = (d*sc)*(q6 - 32) rounded in f32 as the
// codec rounds it, then to bf16.
struct Q6KDecoder {
    static constexpr int BLOCK = lfkt::Q6K_BLOCK;
    static constexpr int SLOT = 240;         // 210 + up to 14 of offset, odd chunks
    static __device__ __forceinline__ void decode32(const uint8_t* blk, int c,
                                                    uint32_t (&out)[16]) {
        const int h = c >> 2, q = c & 3;
        uint32_t ql[8], qh[8];
        lfkt::qmma::load32_a2(blk + h * 64 + (q & 1) * 32, ql);
        lfkt::qmma::load32_a2(blk + 128 + h * 32, qh);
        const int lsh = (q >> 1) * 4, hsh = q * 2;
        const float d = lfkt::f16_at(blk + 208);
        const float s0 = d * static_cast<float>(static_cast<int8_t>(blk[192 + 2 * c]));
        const float s1 = d * static_cast<float>(static_cast<int8_t>(blk[193 + 2 * c]));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const uint32_t v = ((ql[i] >> lsh) & 0x0F0F0F0Fu) | (((qh[i] >> hsh) & 0x03030303u) << 4);
            const float sc = i < 4 ? s0 : s1;
            float f[4];
#pragma unroll
            for (int b = 0; b < 4; ++b)   // 2^23 + q6, less 2^23 + 32
                f[b] = __fmul_rn(sc, __fsub_rn(lfkt::qmma::byte_f(v, b), 8388640.0f));
            out[2 * i] = lfkt::qmma::pack_bf16(f[0], f[1]);
            out[2 * i + 1] = lfkt::qmma::pack_bf16(f[2], f[3]);
        }
    }
};

// The decode path's unit: lane l of step s decodes super-block
// 8s + l / 4, its half h = (l % 4) / 2 and within each quarter q of the
// half the elements 16p .. 16p + 15, p = l % 2 — segments g = q (elements
// 128h + 32g + 16p ..), one int8 scale each, sc[8h + 2g + p].  Element
// 32q + i of the half (i = 16p .. 16p + 15) is nibble q / 2 of ql byte
// 64h + 32(q % 2) + i and crumb q of qh byte 32h + i: 16 bytes of each of
// the two ql runs and 16 of qh serve the lane's four segments.  They come
// out of the warp's exchange (see the header); a lane past the row's last
// super-block (a partial last step) gets d = 0.
struct Q6KGemv {
    static constexpr int ELEMS = lfkt::QK_K, BYTES = lfkt::Q6K_BLOCK;
    static constexpr int STEP = 8 * lfkt::QK_K;
    static constexpr int SPAN = 8 * lfkt::Q6K_BLOCK;   // 1,680 bytes of a row a step
    static constexpr int VECS = SPAN / 16;             // 105
    static constexpr int WORDS = SPAN / 2;             // 840
    static constexpr int SEGS = 4;
    static constexpr bool MIN = true;
    static constexpr float Q0 = 0.5f;                  // q6 handed out as 0.5 + q6 / 256
    // a lane's x segments lie 32 elements apart: swizzled by bits 5..7 of
    // the chunk index (h and the super-block's two low bits), eight lanes
    // of a phase hit eight distinct bank groups
    static constexpr int XSW = 5;
    static constexpr int STAGE = lfkt::qgemv::NR * SPAN;  // one span per weight row
    static constexpr int AHEAD = 1;
    static constexpr bool REFILL_EARLY = true;     // the unit holds the exchanged bytes
    struct RawV { uint4 v[4]; };       // vectors l + 32i (i = 3: lanes 0..8)
    struct RawH { uint32_t h[14]; };   // 16-bit words l + 32i, two a register (i even: low)
    template <bool A16> using Raw = typename std::conditional<A16, RawV, RawH>::type;
    // ql bytes of quarters 0/2 (lo) and 1/3 (hi), qh bytes, the four
    // segments' scales as bytes, d
    struct Unit { uint32_t lo[4], hi[4], qh[4], sc; float d; };

    static __device__ __forceinline__ int sb(int s, int lane) { return s * 8 + (lane >> 2); }
    static __device__ __forceinline__ bool valid(int s, int lane, int K) {
        return sb(s, lane) < K / lfkt::QK_K;
    }
    static __device__ __forceinline__ int x_offset(int s, int lane, int g, int K) {
        return valid(s, lane, K)
            ? sb(s, lane) * lfkt::QK_K + ((lane >> 1) & 1) * 128 + g * 32 + (lane & 1) * 16 : 0;
    }
    // the step's bytes in the row (fewer than SPAN in a last, partial step)
    static __device__ __forceinline__ int span(int s, int K) {
        return min(SPAN, (K / lfkt::QK_K - s * 8) * lfkt::Q6K_BLOCK);
    }
    template <bool A16>
    static __device__ __forceinline__ void load(Raw<A16>& r, const uint8_t* row, int s, int lane,
                                                int K) {
        const uint8_t* p = row + static_cast<size_t>(s) * SPAN;
        if constexpr (A16) {                // 16-byte aligned rows hold a multiple of 8
            const uint4 z = make_uint4(0u, 0u, 0u, 0u);   // blocks: whole steps
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int v = lane + 32 * i;
                r.v[i] = v < VECS ? lfkt::qgemv::ld_stream16(p + 16 * v) : z;
            }
        } else {
            const int rem = span(s, K);
#pragma unroll
            for (int i = 0; i < 14; ++i) {
                uint32_t pair = 0u;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int k = lane + 32 * (2 * i + e);
                    if (k < WORDS && 2 * k < rem) pair |= lfkt::qgemv::ld_stream2(p + 2 * k) << (16 * e);
                }
                r.h[i] = pair;
            }
        }
    }
    template <bool A16>
    static __device__ __forceinline__ void unpack(const Raw<A16> (&r)[lfkt::qgemv::NR],
                                                  Unit (&u)[lfkt::qgemv::NR], int lane,
                                                  uint8_t* st, int s, int K) {
        __syncwarp();                       // every lane has read the last step's span
#pragma unroll
        for (int n = 0; n < lfkt::qgemv::NR; ++n) {
            uint8_t* dst = st + n * SPAN;
            if constexpr (A16) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int v = lane + 32 * i;
                    if (v < VECS) *reinterpret_cast<uint4*>(dst + 16 * v) = r[n].v[i];
                }
            } else {
#pragma unroll
                for (int i = 0; i < 14; ++i)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int k = lane + 32 * (2 * i + e);
                        if (k < WORDS)
                            reinterpret_cast<uint16_t*>(dst)[k] =
                                static_cast<uint16_t>(r[n].h[i] >> (16 * e));
                    }
            }
        }
        __syncwarp();
        const bool ok = valid(s, lane, K);
        const int h = (lane >> 1) & 1, p = lane & 1;
#pragma unroll
        for (int n = 0; n < lfkt::qgemv::NR; ++n) {
            const int blk = n * SPAN + (lane >> 2) * lfkt::Q6K_BLOCK;
            lfkt::qgemv::load_a2<4>(st, blk + 64 * h + 16 * p, u[n].lo);
            lfkt::qgemv::load_a2<4>(st, blk + 64 * h + 32 + 16 * p, u[n].hi);
            lfkt::qgemv::load_a2<4>(st, blk + 128 + 32 * h + 16 * p, u[n].qh);
            uint32_t sc[2];                 // sc[8h .. 8h + 7]
            lfkt::qgemv::load_a2<2>(st, blk + 192 + 8 * h, sc);
            u[n].sc = __byte_perm(sc[0], sc[1], p ? 0x7531u : 0x6420u);  // sc[8h + 2g + p]
            u[n].d = ok ? lfkt::f16_at(st + blk + 208) : 0.f;
        }
    }
    // segment g (quarter g of the half) as 0.5 + q6 / 256, exactly: the
    // nibble g / 2 of its ql run and, shifted to bits 4..5, crumb g of qh
    // make the byte q6, placed in bits 16..23 under 0x3F (sign 0, exponent
    // 2^-1) by one byte permute; the -32 goes into the min, 32*d*sc (exact)
    template <class Raw>
    static __device__ __forceinline__ void segment(const Unit& u, const Raw&, int g,
                                                   float (&q)[16], float& a, float& m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t l = (g & 1) ? u.hi[i] : u.lo[i];
            const uint32_t v = ((l >> (4 * (g >> 1))) & 0x0F0F0F0Fu) |
                               (((u.qh[i] >> (2 * g)) << 4) & 0x30303030u);
#pragma unroll
            for (int b = 0; b < 4; ++b)
                q[4 * i + b] = __uint_as_float(__byte_perm(v, 0x3F000000u, 0x7044u | (b << 8)));
        }
        const float ds = u.d * static_cast<float>(static_cast<int8_t>((u.sc >> (8 * g)) & 0xFFu));
        a = ds * 256.f;
        m = ds * 32.f;
    }
};

}  // namespace

LFKT_API int lfkt_q6k_matmul(const void* x, const void* w, void* y, int B, int N,
                             int K, void* stream) {
    if (B <= 0 || N <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (lfkt::qmma::use_tc(lfkt::qmma::FMT_Q6K, B, K))
        return lfkt::qmma::launch<Q6KDecoder>(x, w, y, B, N, K, s);
    return lfkt::qgemv::launch<Q6KGemv>(x, w, y, B, N, K, s);
}
