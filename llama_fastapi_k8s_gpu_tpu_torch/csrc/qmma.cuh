// Tensor-core GEMM over GGUF block rows, the prompt-pass path of the fused
// dequant-matmuls: y (B, N) bf16 = x (B, K) bf16 . W^T, with W (N, K) held
// as the file's own blocks (one row of K/256 super-blocks per output
// feature; for Q8_0 a "super-block" is a group of eight 32-element blocks).
// Each weight is decoded once per block tile into bf16 (the value the f32
// codec gives, rounded to bf16 once) and multiplied on Hopper's tensor
// cores (wgmma) with f32 accumulators.  The format lives in a decoder (a
// struct with BLOCK, SLOT and decode32(); see q4k_matmul.cu, q5k_matmul.cu,
// q6k_matmul.cu and q8_matmul.cu); everything here is format-free.
//
// A block owns a T x T output tile (tokens x features, T = 64 or 128) and
// walks K in steps of BK = 128 (half a super-block).  A tile of a step is
// two 64-wide atoms of 128-byte rows in the 128-byte swizzle (16-byte chunk
// c of row r at chunk c ^ (r % 8)), the layout wgmma reads.  At step s:
//   - cp.async copies the x tile of step s+2 (s+1 where three x tiles
//     would cost the tile its blocks per SM: Q8_0's 272-byte slots) and,
//     every other step, the raw bytes of a super-block of the tile's T
//     weight rows, two steps before they are decoded (double-buffered);
//     rows whose blocks are not 16-byte aligned (Q6_K's 210-byte blocks in
//     rows of an odd number of them, or a base the wrapper aligned to 2 or
//     8 bytes only) are copied as 16-bit words;
//   - T/64 warpgroups each start m64nTk16 wgmmas over their 64 rows of x
//     and the bf16 W tile of step s, both read from shared memory through
//     descriptors, asynchronously;
//   - meanwhile every thread decodes 64 weights of step s+1 (two threads a
//     weight row) and, once the product has drained, stores them into the
//     other W buffer; one barrier a step;
//   - the epilogue rounds to bf16 and masks the ragged B and N edges.
// One launch per call, no split-K.  B up to 64, and grids of 128 x 128
// tiles too small for half the SMs, take the 64 x 64 tile (four times the
// blocks, two to an SM; a 128 x 128 tile takes up to 221 KB of shared
// memory, one to an SM).
#pragma once

#include "common.cuh"

namespace lfkt {
namespace qmma {

constexpr int BK = 128;                // K elements a pipeline step
constexpr int ROWB = 128;              // bytes of a row of one 64-wide atom
constexpr int STEPS_PER_SB = QK_K / BK;
// the H100's shared memory: at most 227 KB a block, 228 KB an SM of which
// 1 KB is reserved per block
constexpr int SMEM_BLOCK_MAX = 232448;
constexpr int SMEM_SM = 233472;
constexpr int SMEM_RESERVED = 1024;

// dynamic shared memory of a T x T tile with XS x stages: the 1024-byte
// alignment slack, the x stages and two W buffers of two atoms, and the
// raw double buffer
template <class Dec, int T, int XS>
__host__ __device__ constexpr int smem_bytes() { return 1024 + (XS + 2) * 2 * T * ROWB + 2 * T * Dec::SLOT; }

// x tiles in flight: this step's and two ahead, or one ahead where three
// would leave the tile fewer blocks per SM than it is built for (one at
// 128, two at 64) — a decoder with a large SLOT (Q8_0)
template <class Dec, int T>
__host__ __device__ constexpr int xstages() {
    constexpr int bytes = smem_bytes<Dec, T, 3>();
    return bytes <= SMEM_BLOCK_MAX && (T == 128 ? 1 : 2) * (bytes + SMEM_RESERVED) <= SMEM_SM
               ? 3 : 2;
}

// the fused formats, indexing the route's thresholds (the order of
// ops/_fused.py's TC_KERNELS)
enum Format { FMT_Q4K, FMT_Q5K, FMT_Q6K, FMT_Q8_0, N_FORMATS };

// per format, the B at and above which its launcher takes this path (its
// CUDA-core kernel below it); qmma_route.cu holds them and lets a
// measurement change them.
extern int g_tc_min_batch[N_FORMATS];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest N committed groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// byte offset of 16-byte chunk `ch` (0..7) of row `row` of an atom in the
// 128-byte swizzle (the layout wgmma reads with layout type 1)
__device__ __forceinline__ int swz(int row, int ch) {
    return row * ROWB + ((ch ^ (row & 7)) << 4);
}

// 2^23 + byte b of v, as a float: the byte's integer value exactly after
// subtracting 2^23 (cheaper than an int-to-float conversion)
__device__ __forceinline__ float byte_f(uint32_t v, int b) {
    return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 + b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// 32 bytes at a 2-byte aligned shared address as 8 words: nine aligned
// loads, shifted by 16 bits when the address is not 4-byte aligned (the
// payloads of Q6_K's 210-byte and Q8_0's 34-byte blocks)
__device__ __forceinline__ void load32_a2(const uint8_t* p, uint32_t (&v)[8]) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    const uint32_t sh = static_cast<uint32_t>(a & 2) * 8;
    uint32_t lo = w[0];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const uint32_t hi = w[i + 1];
        v[i] = __funnelshift_r(lo, hi, sh);
        lo = hi;
    }
}

// Descriptor of a K-major bf16 tile with 128-byte rows in the 128-byte
// swizzle, from a 1024-byte aligned base (a k16 slice starts 32 bytes
// further): start address, LBO 16 B (unused by this layout), SBO 1024 B
// (8 rows), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    const uint64_t a = smem_u32(p);
    return ((a & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
           (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across the async MMA
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32, the warpgroup's fragment) += A (64 x 16) . B (N x 16)^T,
// both bf16 from shared memory
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

template <int T>
__device__ __forceinline__ void wgmma_tile(float (&d)[T / 2], uint64_t da, uint64_t db) {
    if constexpr (T == 128) wgmma_m64n128(d, da, db);
    else wgmma_m64n64(d, da, db);
}

template <class Dec, int T, bool A16>
__global__ void __launch_bounds__(T * 2, T == 128 ? 1 : 2)
qmma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
            __nv_bfloat16* __restrict__ y, int B, int N, int K) {
    constexpr int THREADS = T * 2;                   // a warpgroup per 64 rows; two
                                                     // decoding threads a weight row
    constexpr int XS = xstages<Dec, T>();
    constexpr int AHEAD = XS - 1;                    // steps an x tile is copied ahead
    extern __shared__ uint8_t smem_raw[];
    // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    constexpr int ATOM = T * ROWB;                   // bytes of one atom
    uint8_t* xs = smem;                              // [XS][2][T][ROWB]
    uint8_t* ws = xs + XS * 2 * ATOM;                // [2][2][T][ROWB]
    uint8_t* raw = ws + 2 * 2 * ATOM;                // [2][T][SLOT]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wg = warp >> 2;
    const int m0 = blockIdx.x * T, n0 = blockIdx.y * T;
    const int nb = K / QK_K;
    const size_t row_bytes = static_cast<size_t>(nb) * Dec::BLOCK;
    const int steps = nb * STEPS_PER_SB;

    auto load_x = [&](int s) {
        uint8_t* dst = xs + (s % XS) * 2 * ATOM;
        const int k0 = s * BK;
        for (int i = tid; i < T * 16; i += THREADS) {
            const int r = i >> 4, c = i & 15;
            const int b = min(m0 + r, B - 1);        // rows past B: any valid row
            cp_async16(dst + (c >> 3) * ATOM + swz(r, c & 7),
                       x + static_cast<size_t>(b) * K + k0 + c * 8);
        }
    };
    auto load_raw = [&](int sb) {
        uint8_t* dst = raw + (sb & 1) * T * Dec::SLOT;
        if constexpr (A16) {
            // the 16-byte aligned span holding the block; its offset in the
            // span is the same for every row
            constexpr int CH = Dec::SLOT / 16;
            const int off = (sb * Dec::BLOCK) & 15;
            const int chunks = (off + Dec::BLOCK + 15) >> 4;
            for (int i = tid; i < T * CH; i += THREADS) {
                const int r = i / CH, ch = i - r * CH;
                if (ch >= chunks) continue;
                const int n = min(n0 + r, N - 1);
                const uint8_t* src = w + n * row_bytes + sb * Dec::BLOCK - off;
                cp_async16(dst + r * Dec::SLOT + ch * 16, src + ch * 16);
            }
        } else {
            constexpr int HW = Dec::BLOCK / 2;
            for (int i = tid; i < T * HW; i += THREADS) {
                const int r = i / HW, h = i - r * HW;
                const int n = min(n0 + r, N - 1);
                const uint16_t* src =
                    reinterpret_cast<const uint16_t*>(w + n * row_bytes + sb * Dec::BLOCK);
                reinterpret_cast<uint16_t*>(dst + r * Dec::SLOT)[h] = src[h];
            }
        }
    };
    // this thread's share of step s's W tile: the 64 weights of row drow in
    // atom dhalf (32-element chunks 2*dhalf and 2*dhalf + 1 of the step)
    const int drow = tid >> 1, dhalf = tid & 1;
    auto decode = [&](int s, uint32_t (&v0)[16], uint32_t (&v1)[16]) {
        const int sb = s / STEPS_PER_SB;
        const int off = A16 ? ((sb * Dec::BLOCK) & 15) : 0;
        const uint8_t* blk = raw + ((sb & 1) * T + drow) * Dec::SLOT + off;
        const int c = (s % STEPS_PER_SB) * 4 + dhalf * 2;
        Dec::decode32(blk, c, v0);
        Dec::decode32(blk, c + 1, v1);
    };
    auto store_w = [&](int s, const uint32_t (&v0)[16], const uint32_t (&v1)[16]) {
        uint8_t* dst = ws + ((s & 1) * 2 + dhalf) * ATOM + drow * ROWB;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            *reinterpret_cast<uint4*>(dst + ((q ^ (drow & 7)) << 4)) =
                make_uint4(v0[4 * q], v0[4 * q + 1], v0[4 * q + 2], v0[4 * q + 3]);
            *reinterpret_cast<uint4*>(dst + (((q + 4) ^ (drow & 7)) << 4)) =
                make_uint4(v1[4 * q], v1[4 * q + 1], v1[4 * q + 2], v1[4 * q + 3]);
        }
    };

    float acc[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) acc[i] = 0.f;

    // x(0) (and x(1)) and the first two super-blocks in flight; decode W(0)
    load_raw(0);
    load_x(0);
    if constexpr (AHEAD == 2) {
        cp_async_commit();
        load_x(1);
    }
    if (nb > 1) load_raw(1);
    cp_async_commit();
    cp_async_wait<AHEAD - 1>();
    __syncthreads();
    {
        uint32_t v0[16], v1[16];
        decode(0, v0, v1);
        store_w(0, v0, v1);
    }
    for (int s = 0; s < steps; ++s) {
        cp_async_wait<AHEAD - 1>();                  // x(s) and raw((s+1)/2) landed
        fence_proxy_async();                         // this thread's x and W stores
        __syncthreads();                             // ...for every thread
        if (s + AHEAD < steps) load_x(s + AHEAD);
        // super-block sb is decoded at steps 2sb and 2sb+1, in iterations
        // 2sb-1 and 2sb: it is copied in iteration 2sb-3
        if ((s & 1) && (s + 3) / 2 < nb) load_raw((s + 3) / 2);
        cp_async_commit();
        const uint8_t* xb = xs + (s % XS) * 2 * ATOM + wg * 64 * ROWB;
        const uint8_t* wb = ws + (s & 1) * 2 * ATOM;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            const int at = (kk >> 2) * ATOM + (kk & 3) * 32;   // k16 slice kk
            wgmma_tile<T>(acc, sw128_desc(xb + at), sw128_desc(wb + at));
        }
        wgmma_commit();
        const bool next = s + 1 < steps;
        uint32_t v0[16], v1[16];
        if (next) decode(s + 1, v0, v1);             // overlaps the async product
        wgmma_wait_all();
        fence_regs(acc);
        if (next) store_w(s + 1, v0, v1);
    }

    // accumulator i: n8 chunk i/4; rows g (+8 for i%4 >= 2), columns 2t, 2t+1
    const int g = lane >> 2, t = lane & 3;
    const int mrow = m0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int m = mrow + hr * 8;
            const int n = n0 + j * 8 + 2 * t;
            if (m >= B || n >= N) continue;
            __nv_bfloat16* dst = y + static_cast<size_t>(m) * N + n;
            const float v0 = acc[4 * j + 2 * hr], v1 = acc[4 * j + 2 * hr + 1];
            if ((N & 1) == 0) {
                *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
            } else {
                dst[0] = __float2bfloat16_rn(v0);
                if (n + 1 < N) dst[1] = __float2bfloat16_rn(v1);
            }
        }
}

template <class Dec, int T, bool A16>
int launch_tile(const void* x, const void* w, void* y, int B, int N, int K, cudaStream_t s) {
    constexpr int SMEM = smem_bytes<Dec, T, xstages<Dec, T>()>();
    static_assert(SMEM <= SMEM_BLOCK_MAX, "tile does not fit a block's shared memory");
    auto kern = qmma_kernel<Dec, T, A16>;
    // above 48 KB of dynamic shared memory a kernel must opt in, per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    static unsigned long long configured = 0;        // one bit per device
    if (dev >= 64 || !(configured >> dev & 1ull)) {
        e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     static_cast<int>(cudaSharedmemCarveoutMaxShared));
        if (e != cudaSuccess) return static_cast<int>(e);
        if (dev < 64) configured |= 1ull << dev;
    }
    const dim3 grid((B + T - 1) / T, (N + T - 1) / T);
    kern<<<grid, T * 2, SMEM, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
        static_cast<__nv_bfloat16*>(y), B, N, K);
    return static_cast<int>(cudaGetLastError());
}

inline int sm_count() {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 0;
    return n;
}

template <class Dec, bool A16>
int launch_a(const void* x, const void* w, void* y, int B, int N, int K, cudaStream_t s) {
    // 128 x 128 tiles where B fills more than half of one and they cover
    // half the SMs (one block fits an SM), else 64 x 64 (4x the blocks, two
    // to an SM)
    const long long blocks = static_cast<long long>((B + 127) / 128) * ((N + 127) / 128);
    if (B > 64 && 2 * blocks >= sm_count()) return launch_tile<Dec, 128, A16>(x, w, y, B, N, K, s);
    return launch_tile<Dec, 64, A16>(x, w, y, B, N, K, s);
}

// The tensor-core path for any whole-block shape: x must be 16-byte aligned
// (ops/_fused.py hands over an aligned copy of any other x; a misaligned x
// is refused here as the last guard); W takes 16-byte copies where its base
// and row stride allow them, 16-bit copies otherwise.
template <class Dec>
int launch(const void* x, const void* w, void* y, int B, int N, int K, cudaStream_t s) {
    if (reinterpret_cast<uintptr_t>(x) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
    const size_t row_bytes = static_cast<size_t>(K / QK_K) * Dec::BLOCK;
    if (reinterpret_cast<uintptr_t>(w) % 16 == 0 && row_bytes % 16 == 0)
        return launch_a<Dec, true>(x, w, y, B, N, K, s);
    return launch_a<Dec, false>(x, w, y, B, N, K, s);
}

// the route of a call of format fmt with B activation rows and depth K:
// tensor cores at and above the format's threshold, where K is whole
// 256-element groups (always for the K-quants; Q8_0 rows may end in a
// partial group)
inline bool use_tc(Format fmt, int B, int K) {
    return B >= g_tc_min_batch[fmt] && K % QK_K == 0;
}

}  // namespace qmma
}  // namespace lfkt
