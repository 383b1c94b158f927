// Shared definitions of the rrtmg_lw_torch CUDA kernels.
//
// Every entry point has a plain C interface (bound from Python with
// ctypes): raw device pointers, ints and the CUDA stream, and it returns
// cudaGetLastError() after its launch.  The kernels allocate nothing and
// never synchronise.
#pragma once

#include <cuda_runtime.h>

#define RRTM_API extern "C" __attribute__((visibility("default")))

namespace rrtm {

constexpr int NGPT = 140;      // g-points
constexpr int NGPT_PAD = 144;  // g rows of the compact McICA mask
constexpr int NBAND = 16;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return min(max(x, lo), hi);
}

}  // namespace rrtm
