// The route of the fused dequant-matmuls (q4k_matmul.cu, q5k_matmul.cu,
// q6k_matmul.cu, q8_matmul.cu): the tensor-core template of qmma.cuh from
// the format's threshold on, where K is whole 256-element groups, the
// CUDA-core kernels otherwise.
#include "qmma.cuh"

namespace lfkt {
namespace qmma {

// chip_smoke.py's route_layer lines on the H100 (both paths forced in turn,
// summed over one layer's linears of each file): from 8 rows on the tensor
// cores take less time over a layer of a Q4_K_M, Q5_K_M or Q6_K file; over
// a Q8_0 file's layer they lose by 13% at 8 rows and win by ~40% from 9,
// where the CUDA-core kernel needs a second pass over the weights (RB = 8
// rows a pass); below 8 the two trade places by shape
int g_tc_min_batch[N_FORMATS] = {8, 8, 8, 9};

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
