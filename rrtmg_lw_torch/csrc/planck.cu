// K3: Planck-table interpolation at layer or level temperatures.
//
// Replaces rrtmg_lw_tpu/ops/planck_pallas.py::_build.kernel.  The TPU
// kernel selected the two table rows with a binary one-hot matmul over a
// 3-level bf16 split of totplnk; here the 181x16 table sits in shared
// memory and each thread reads its two rows directly.
//
// Bound on the H100: bytes.  Each (level, column) reads one float and
// writes 16, so the kernel moves ~68 B per cell and does ~3 flops per
// output.  Design: one thread per (level, column), columns fastest, so
// the 16 stores of a warp each cover 32 consecutive floats of the
// (N, 16, B) output (coalesced); the table is loaded once per block.
//
// Arithmetic matches setcoef._planck_index/_interp_planck operation for
// operation: x = T - 159, ind = clamp(trunc(x), 1, 180), frac = x - ind,
// out = lo + frac * (hi - lo).
#include "rrtm.cuh"

namespace {

constexpr int NROW = 181;
constexpr int THREADS = 256;

__global__ void planck_kernel(const float* __restrict__ temp,
                              const float* __restrict__ totplnk,
                              float* __restrict__ out, int B) {
    __shared__ float tab[NROW * rrtm::NBAND];
    for (int i = threadIdx.x; i < NROW * rrtm::NBAND; i += blockDim.x)
        tab[i] = totplnk[i];
    __syncthreads();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const int n = blockIdx.y;
    if (b >= B) return;
    const float x = temp[(size_t)n * B + b] - 159.0f;
    const int ind = rrtm::clampi((int)x, 1, 180);
    const float frac = x - (float)ind;
    const float* lo = tab + (ind - 1) * rrtm::NBAND;
    const float* hi = tab + ind * rrtm::NBAND;
    float* o = out + (size_t)n * rrtm::NBAND * B + b;
#pragma unroll
    for (int k = 0; k < rrtm::NBAND; ++k)
        o[(size_t)k * B] = lo[k] + frac * (hi[k] - lo[k]);
}

}  // namespace

// temp (N, B) -> out (N, 16, B); totplnk (181, 16).
RRTM_API int rrtm_planck(const float* temp, const float* totplnk, float* out,
                         int N, int B, void* stream) {
    if (N > 0 && B > 0) {
        dim3 grid((B + THREADS - 1) / THREADS, N);
        planck_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            temp, totplnk, out, B);
    }
    return (int)cudaGetLastError();
}

RRTM_API const char* rrtm_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
