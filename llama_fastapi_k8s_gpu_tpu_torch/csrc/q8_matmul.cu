// Fused Q8_0 dequant-matmul: y (B, N) bf16 = x (B, K) bf16 . W^T, with W
// (N, K) held as its raw GGUF Q8_0 blocks (34 bytes per 32 weights: f16 d
// then 32 int8), one row of K/32 blocks per output feature.  f32
// accumulation, bf16 out.
//
// Replaces: llama_fastapi_k8s_gpu_tpu/ops/pallas/q8matmul.py::
// _q8_matmul_kernel (q8_matmul / q8_matmul_stacked).  The Pallas kernel
// took a host repack (element-major int8 columns, block scales folded to
// bf16 and duplicated over 128 lanes); this one reads the file's blocks and
// multiplies by the exact f16 d in f32, so loading a weight is an upload.
//
// Bound on the H100: bytes at decode (B = 1: 8.5 bits/weight read once,
// 2 flops/weight), operations at prefill (B = 256).  Two paths
// (qmma_route.cu):
//   - B >= the route's threshold and K a multiple of 256 (every prompt pass
//     at the 8B shapes): the tensor-core template of qmma.cuh with the
//     Q8_0 decoder below, which treats eight blocks (272 bytes, 256
//     weights) as the template's super-block and turns each block into
//     bf16 — d*q exact in f32, rounded once, so the product is the bf16
//     plane's;
//   - otherwise (decode; any K that is a multiple of 32 only): the
//     CUDA-core path of qgemv.cuh with the Q8_0 unit decoder below
//     (Q8Gemv).  A warp step is 32 blocks of a row (1,088 bytes, 16-byte
//     aligned at every 8B shape); lane l decodes block l of the step:
//     acc += d*sum(q*x), d exact f32.
//
// Alignment: a 34-byte block is only 2-byte aligned, so no lane can load
// its own 32 payload bytes wide.  The warp loads the step's 1,088 bytes as
// 68 16-byte vectors (where the row allows; as 16-bit words otherwise),
// stores them to a buffer of its own in shared memory and reads its block
// back as nine aligned words shifted by 16 bits where needed — the
// exchange is within the warp (__syncwarp), with no block barrier.  Chosen
// over shuffles: a block spans three vectors at a lane-dependent byte
// offset, which shuffles would need a run-time register index (or a chain
// of selects) to realign; shared memory realigns by address.
#include "qgemv.cuh"
#include "qmma.cuh"

namespace {

// Weights 32c..32c+31 — Q8_0 block c of a group of eight, at byte 34c of
// the 272-byte group (16-byte aligned in shared memory) — as 16 bf16
// pairs.  The payload is 2-byte aligned: read as words with funnel shifts
// (for c = 7 the last aligned word lies past the group, in the next slot
// or the allocation's alignment slack, and is not used).  q from each byte
// exactly: b ^ 0x80 is q + 128, as 2^23 + q + 128 through byte_f; then
// w = d*q, exact in f32 (11 + 8 bits) as the codec computes it, rounded
// once to bf16.  The 272-byte slot leaves room for two x stages, not three
// (qmma.cuh xstages).
struct Q8Decoder {
    static constexpr int BLOCK = 8 * lfkt::Q8_0_BLOCK;   // 272: seventeen 16-byte chunks
    static constexpr int SLOT = BLOCK;
    static __device__ __forceinline__ void decode32(const uint8_t* grp, int c,
                                                    uint32_t (&out)[16]) {
        const uint8_t* blk = grp + c * lfkt::Q8_0_BLOCK;
        const float d = lfkt::f16_at(blk);
        uint32_t qs[8];
        lfkt::qmma::load32_a2(blk + 2, qs);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const uint32_t u = qs[i] ^ 0x80808080u;
            float f[4];
#pragma unroll
            for (int b = 0; b < 4; ++b)   // 2^23 + q + 128, less 2^23 + 128
                f[b] = __fmul_rn(d, __fsub_rn(lfkt::qmma::byte_f(u, b), 8388736.0f));
            out[2 * i] = lfkt::qmma::pack_bf16(f[0], f[1]);
            out[2 * i + 1] = lfkt::qmma::pack_bf16(f[2], f[3]);
        }
    }
};

// The decode path's unit: lane l of step s decodes block 32s + l (its 32
// int8, as segments g = 0, 1 of 16) after the warp's exchange of the
// step's bytes through shared memory (see the header).  A lane past the
// row's last block (a partial last step) gets d = 0.
struct Q8Gemv {
    static constexpr int ELEMS = lfkt::QK8_0, BYTES = lfkt::Q8_0_BLOCK;
    static constexpr int STEP = 32 * lfkt::QK8_0;
    static constexpr int SPAN = 32 * lfkt::Q8_0_BLOCK;    // 1,088 bytes of a row a step
    static constexpr int SEGS = 2;
    static constexpr bool MIN = false;
    static constexpr float Q0 = 0.f;
    static constexpr int XSW = 3;               // a lane's x run: 2^XSW 16-byte chunks
    static constexpr int STAGE = lfkt::qgemv::NR * SPAN;  // one span per weight row
    static constexpr int AHEAD = 2;
    static constexpr bool REFILL_EARLY = true;     // the unit holds the exchanged bytes
    struct RawV { uint4 v[3]; };           // vectors l, 32 + l and (lanes 0..3) 64 + l
    struct RawH { uint32_t h[17]; };       // 16-bit words l + 32i
    template <bool A16> using Raw = typename std::conditional<A16, RawV, RawH>::type;
    struct Unit { float d; uint32_t q[8]; };

    static __device__ __forceinline__ int blk(int s, int lane) { return s * 32 + lane; }
    static __device__ __forceinline__ bool valid(int s, int lane, int K) {
        return blk(s, lane) < K / lfkt::QK8_0;
    }
    static __device__ __forceinline__ int x_offset(int s, int lane, int g, int K) {
        return valid(s, lane, K) ? blk(s, lane) * lfkt::QK8_0 + g * 16 : 0;
    }
    // the step's bytes in the row (fewer than SPAN in a last, partial step)
    static __device__ __forceinline__ int span(int s, int K) {
        return min(SPAN, (K / lfkt::QK8_0 - s * 32) * lfkt::Q8_0_BLOCK);
    }
    template <bool A16>
    static __device__ __forceinline__ void load(Raw<A16>& r, const uint8_t* row, int s, int lane,
                                                int K) {
        const int rem = span(s, K);
        const uint8_t* p = row + static_cast<size_t>(s) * SPAN;
        if constexpr (A16) {                // rem is whole vectors: A16 rows are
            const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                const int v = lane + 32 * i;
                r.v[i] = v < SPAN / 16 && 16 * v < rem ? lfkt::qgemv::ld_stream16(p + 16 * v) : z;
            }
        } else {
#pragma unroll
            for (int i = 0; i < 17; ++i) {
                const int k = lane + 32 * i;
                r.h[i] = 2 * k < rem ? lfkt::qgemv::ld_stream2(p + 2 * k) : 0u;
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
                for (int i = 0; i < 3; ++i) {
                    const int v = lane + 32 * i;
                    if (v < SPAN / 16) *reinterpret_cast<uint4*>(dst + 16 * v) = r[n].v[i];
                }
            } else {
#pragma unroll
                for (int i = 0; i < 17; ++i)
                    reinterpret_cast<uint16_t*>(dst)[lane + 32 * i] =
                        static_cast<uint16_t>(r[n].h[i]);
            }
        }
        __syncwarp();
        const bool ok = valid(s, lane, K);
#pragma unroll
        for (int n = 0; n < lfkt::qgemv::NR; ++n) {
            const int off = n * SPAN + lane * lfkt::Q8_0_BLOCK;
            u[n].d = ok ? lfkt::f16_at(st + off) : 0.f;
            lfkt::qgemv::load_a2<8>(st, off + 2, u[n].q);
        }
    }
    // q from each byte exactly: b ^ 0x80 is q + 128, 2^23 + q + 128 through
    // byte_f, less 2^23 + 128
    template <class Raw>
    static __device__ __forceinline__ void segment(const Unit& u, const Raw&, int g,
                                                   float (&q)[16], float& a, float& m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t v = u.q[4 * g + i] ^ 0x80808080u;
#pragma unroll
            for (int b = 0; b < 4; ++b)
                q[4 * i + b] = __fsub_rn(lfkt::qmma::byte_f(v, b), 8388736.0f);
        }
        a = u.d;
        m = 0.f;
    }
};

}  // namespace

LFKT_API int lfkt_q8_matmul(const void* x, const void* w, void* y, int B, int N,
                            int K, void* stream) {
    if (B <= 0 || N <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (lfkt::qmma::use_tc(lfkt::qmma::FMT_Q8_0, B, K))
        return lfkt::qmma::launch<Q8Decoder>(x, w, y, B, N, K, s);
    return lfkt::qgemv::launch<Q8Gemv>(x, w, y, B, N, K, s);
}
