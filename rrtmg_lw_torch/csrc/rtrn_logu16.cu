// K1 (rtrn_kernel.cuh) with taut / fracs stored as logu16 (spec.cuh):
// 6 modes x idrv 0/1, in a translation unit of their own.
#include "rtrn_kernel.cuh"

cudaError_t rrtm::rt::launch_logu16(const Inputs& in, const float* taua,
                                    const int* ngb, const float* wg,
                                    float* out, int mode, int idrv,
                                    cudaStream_t s) {
    return launch_storage<rrtm::SPEC_LOGU16>(in, taua, ngb, wg, out, mode,
                                             idrv, s);
}

cudaError_t rrtm::rt::info_logu16(int mode, int idrv, int* out) {
    return info_storage<rrtm::SPEC_LOGU16>(mode, idrv, out);
}
