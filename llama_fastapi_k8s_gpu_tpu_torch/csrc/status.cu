// The text of a CUDA status code, for the Python wrappers' error messages
// (the library links its own CUDA runtime, so the name comes from here).
#include "common.cuh"

LFKT_API const char* lfkt_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}
