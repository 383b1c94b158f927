// K3: Planck-table interpolation at layer or level temperatures, and
// K3b, its backward (below K3).
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

// K3b: the backward of K3, replacing the XLA backward of the custom_vjp
// at planck_pallas.py:137-159 (the TPU picked the slope row with a
// one-hot matmul).  d out[n,k,b] / dT = tab[ind,k] - tab[ind-1,k]: frac
// has unit derivative, on the clamp branches too, which extrapolate with
// the same slope.  ct_T[n,b] = sum_k ct[n,k,b] * slope[ind-1,k], summed
// in k order: deterministic.  Bound by bytes like K3 (reads 16 floats,
// writes one per cell); the slope table sits in shared memory.
__global__ void planck_bwd_kernel(const float* __restrict__ temp,
                                  const float* __restrict__ totplnk,
                                  const float* __restrict__ ct,
                                  float* __restrict__ ct_t, int B) {
    __shared__ float slope[(NROW - 1) * rrtm::NBAND];
    for (int i = threadIdx.x; i < (NROW - 1) * rrtm::NBAND; i += blockDim.x)
        slope[i] = totplnk[i + rrtm::NBAND] - totplnk[i];
    __syncthreads();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const int n = blockIdx.y;
    if (b >= B) return;
    const float x = temp[(size_t)n * B + b] - 159.0f;
    const int ind = rrtm::clampi((int)x, 1, 180);
    const float* s = slope + (ind - 1) * rrtm::NBAND;
    const float* c = ct + (size_t)n * rrtm::NBAND * B + b;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < rrtm::NBAND; ++k) acc = acc + c[(size_t)k * B] * s[k];
    ct_t[(size_t)n * B + b] = acc;
}

}  // namespace

// temp (N, B), totplnk (181, 16), ct (N, 16, B) -> ct_t (N, B).
RRTM_API int rrtm_planck_bwd(const float* temp, const float* totplnk,
                             const float* ct, float* ct_t, int N, int B,
                             void* stream) {
    if (N > 0 && B > 0) {
        dim3 grid((B + THREADS - 1) / THREADS, N);
        planck_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            temp, totplnk, ct, ct_t, B);
    }
    return (int)cudaGetLastError();
}

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
