// The route of the fused dequant-matmuls (q4k_matmul.cu, q5k_matmul.cu,
// q6k_matmul.cu, q8_matmul.cu): the tensor-core template of qmma.cuh from
// the format's threshold on, where K is whole 256-element groups, the
// CUDA-core kernels otherwise.
#include "qmma.cuh"

namespace lfkt {
namespace qmma {

// chip_smoke.py's route_layer lines on the H100 (both paths forced in turn,
// the weights cold, summed over one layer's linears of each format): Q4_K
// from 7 rows on — since its decode path moved to qgemv.cuh, its layer
// takes 284-287 us on the CUDA cores against 316-319 on the tensor cores
// at 6 rows, and 324-327 against 292-294 at 7; Q8_0 from 9 — its layer
// takes 401-404 us on the CUDA cores against 548-549 at 8 rows, and
// 748-752 against 548-552 at 9, where the CUDA-core path needs a second
// pass over the weights (8 rows a pass); Q5_K and Q6_K from 8, as their
// CUDA-core kernels left them
int g_tc_min_batch[N_FORMATS] = {7, 8, 8, 9};

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
