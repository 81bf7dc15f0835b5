// The route of the fused K-quant matmuls (q5k_matmul.cu, q6k_matmul.cu):
// the tensor-core template of qmma.cuh at B >= g_tc_min_batch, the
// CUDA-core kernels below it.  The route depends on B alone.
#include "qmma.cuh"

namespace lfkt {
namespace qmma {

// chip_smoke.py's route_sweep lines on the H100: from 8 rows on, the
// tensor-core path takes less time over a layer's linears of a Q5_K_M or
// a Q6_K file (from 9, when the CUDA-core kernel needs a second pass over
// the weights, about half); below 8 the two trade places by shape
int g_tc_min_batch = 8;

}  // namespace qmma
}  // namespace lfkt

// 1 when a call with B activation rows takes the tensor cores
LFKT_API int lfkt_fused_tc_route(int B) { return lfkt::qmma::use_tc(B) ? 1 : 0; }

// For measurement only: take the tensor cores from min_batch rows on.
// Returns 0, or cudaErrorInvalidValue for min_batch < 1.
LFKT_API int lfkt_fused_tc_config(int min_batch) {
    if (min_batch < 1) return static_cast<int>(cudaErrorInvalidValue);
    lfkt::qmma::g_tc_min_batch = min_batch;
    return 0;
}
