// The route of the fused dequant-matmuls (q4k_matmul.cu, q5k_matmul.cu,
// q6k_matmul.cu, q8_matmul.cu): the tensor-core template of qmma.cuh from
// the format's threshold on, where K is whole 256-element groups, the
// matrix-vector template of qgemv.cuh otherwise.
#include "qmma.cuh"

namespace lfkt {
namespace qmma {

// chip_smoke.py's route_layer lines on the H100 (both paths forced in turn,
// the weights cold, summed over one layer's linears of each format in the
// file that serves it most; two runs): a format takes the tensor cores
// from the smallest B from which they win at every larger B.  Q4_K from 7
// rows on — its layer takes 285-287 us on the CUDA cores against 322 on
// the tensor cores at 6 rows, 326-329 against 294-295 at 7; Q5_K from 7 —
// 288-293 against 326-327 at 6, 331-333 against 301-302 at 7; Q6_K from 9
// (the Q6_K file's layer) — 435-437 against 532-533 at 8, 822-837 against
// 514 at 9, where the CUDA-core path needs a second pass over the weights
// (8 rows a pass); Q8_0 from 9 — 403-406 against 548-550 at 8, 750-751
// against 545-548 at 9
int g_tc_min_batch[N_FORMATS] = {7, 7, 9, 9};

}  // namespace qmma
}  // namespace lfkt

// 1 when a call of format fmt (qmma::Format) with B activation rows and
// depth K takes the tensor cores
LFKT_API int lfkt_fused_tc_route(int fmt, int B, int K) {
    if (fmt < 0 || fmt >= lfkt::qmma::N_FORMATS) return 0;
    return lfkt::qmma::use_tc(static_cast<lfkt::qmma::Format>(fmt), B, K) ? 1 : 0;
}

// For measurement only: make format fmt take the tensor cores from
// min_batch rows on.  Returns 0, or cudaErrorInvalidValue for an unknown
// format or min_batch < 1.
LFKT_API int lfkt_fused_tc_config(int fmt, int min_batch) {
    if (fmt < 0 || fmt >= lfkt::qmma::N_FORMATS || min_batch < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    lfkt::qmma::g_tc_min_batch[fmt] = min_batch;
    return 0;
}
