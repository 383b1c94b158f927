// K4: ice and liquid cloud absorption coefficients per band, and K4b,
// its backward (below K4).
//
// Replaces rrtmg_lw_tpu/ops/cldcoef_pallas.py::_build.kernel.  The TPU
// kernel selected the two table rows in effective radius with one-hot
// matmuls; here the ice table (Key-Streamer absice2, 43 rows, or Fu
// absice3, 46 rows) and the Hu-Stamnes liquid table (absliq1, 58 rows)
// sit in shared memory and each thread reads its rows directly.
//
// Bound on the H100: bytes.  Each (layer, column) reads 2 floats and
// writes 32.  Design: one thread per (layer, column), columns fastest,
// so the stores to the (L, 16, B) outputs coalesce.
//
// Arithmetic matches cldprop._ice_liq_coeffs (rrtmg_lw_cldprmc.f90:
// 210-268), including the special cases: ice factor = (reic - 2) / 3 as
// a true division, index == nmax -> nmax - 1, then clamp to [1, nmax-1];
// liquid index 0 -> 1 and 58 -> 57, then clamp to [1, 57].
#include "rrtm.cuh"

namespace {

constexpr int MAX_ICE_ROWS = 46;
constexpr int LIQ_ROWS = 58;
constexpr int THREADS = 256;

__global__ void cldcoef_kernel(const float* __restrict__ reic_t,
                               const float* __restrict__ relq_t,
                               const float* __restrict__ ice,
                               const float* __restrict__ liq,
                               float* __restrict__ abi,
                               float* __restrict__ abl, int nmax, int B) {
    constexpr int NB = rrtm::NBAND;
    __shared__ float ice_s[MAX_ICE_ROWS * NB];
    __shared__ float liq_s[LIQ_ROWS * NB];
    for (int i = threadIdx.x; i < nmax * NB; i += blockDim.x)
        ice_s[i] = ice[i];
    for (int i = threadIdx.x; i < LIQ_ROWS * NB; i += blockDim.x)
        liq_s[i] = liq[i];
    __syncthreads();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const int l = blockIdx.y;
    if (b >= B) return;
    const size_t cell = (size_t)l * B + b;

    const float factor = (reic_t[cell] - 2.0f) / 3.0f;
    int idx = (int)factor;
    if (idx == nmax) idx = nmax - 1;
    idx = rrtm::clampi(idx, 1, nmax - 1);
    float fint = factor - (float)idx;
    const float* lo = ice_s + (idx - 1) * NB;
    const float* hi = ice_s + idx * NB;
    float* o = abi + (size_t)l * NB * B + b;
#pragma unroll
    for (int k = 0; k < NB; ++k)
        o[(size_t)k * B] = lo[k] + fint * (hi[k] - lo[k]);

    const float x = relq_t[cell] - 1.5f;
    idx = (int)x;
    if (idx == 0) idx = 1;
    if (idx == LIQ_ROWS) idx = LIQ_ROWS - 1;
    idx = rrtm::clampi(idx, 1, LIQ_ROWS - 1);
    fint = x - (float)idx;
    lo = liq_s + (idx - 1) * NB;
    hi = liq_s + idx * NB;
    o = abl + (size_t)l * NB * B + b;
#pragma unroll
    for (int k = 0; k < NB; ++k)
        o[(size_t)k * B] = lo[k] + fint * (hi[k] - lo[k]);
}

// K4b: the backward of K4 with respect to the effective radii.  The TPU
// kernel had no vjp (cldcoef_pallas.py:107): it replaces the XLA autodiff
// of the JAX package's _ice_liq_coeffs (rrtmg_lw_tpu/ops/cldprop.py:43),
// which the JAX model's gradients go through.  The table rows are fixed
// by the integer index (its clamps carry no gradient), so each
// coefficient is linear in the radius with the slope of its interval,
// the clamped one past the table's ends: ct_reic = sum over the bands
// of ct_abi x (hi - lo), over 3 (factor = (reic - 2) / 3), ct_relq = the
// same of ct_abl (fint = relq - 1.5 - index), each summed in band order.
// Bound on the H100: bytes; each (layer, column) reads 34 floats and
// writes 2.  One thread per (layer, column), columns fastest, as K4.
__global__ void cldcoef_bwd_kernel(const float* __restrict__ reic_t,
                                   const float* __restrict__ relq_t,
                                   const float* __restrict__ ice,
                                   const float* __restrict__ liq,
                                   const float* __restrict__ ct_abi,
                                   const float* __restrict__ ct_abl,
                                   float* __restrict__ ct_reic,
                                   float* __restrict__ ct_relq, int nmax,
                                   int B) {
    constexpr int NB = rrtm::NBAND;
    __shared__ float ice_s[MAX_ICE_ROWS * NB];
    __shared__ float liq_s[LIQ_ROWS * NB];
    for (int i = threadIdx.x; i < nmax * NB; i += blockDim.x)
        ice_s[i] = ice[i];
    for (int i = threadIdx.x; i < LIQ_ROWS * NB; i += blockDim.x)
        liq_s[i] = liq[i];
    __syncthreads();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const int l = blockIdx.y;
    if (b >= B) return;
    const size_t cell = (size_t)l * B + b;

    const float factor = (reic_t[cell] - 2.0f) / 3.0f;
    int idx = (int)factor;
    if (idx == nmax) idx = nmax - 1;
    idx = rrtm::clampi(idx, 1, nmax - 1);
    const float* lo = ice_s + (idx - 1) * NB;
    const float* hi = ice_s + idx * NB;
    const float* c = ct_abi + (size_t)l * NB * B + b;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NB; ++k) acc = acc + c[(size_t)k * B] * (hi[k] - lo[k]);
    ct_reic[cell] = acc / 3.0f;

    const float x = relq_t[cell] - 1.5f;
    idx = (int)x;
    if (idx == 0) idx = 1;
    if (idx == LIQ_ROWS) idx = LIQ_ROWS - 1;
    idx = rrtm::clampi(idx, 1, LIQ_ROWS - 1);
    lo = liq_s + (idx - 1) * NB;
    hi = liq_s + idx * NB;
    c = ct_abl + (size_t)l * NB * B + b;
    acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NB; ++k) acc = acc + c[(size_t)k * B] * (hi[k] - lo[k]);
    ct_relq[cell] = acc;
}

}  // namespace

// reic_t, relq_t (L, B); ice (nmax, 16); liq (58, 16); ct_abi, ct_abl
// (L, 16, B) -> ct_reic_t, ct_relq_t (L, B).
RRTM_API int rrtm_cldcoef_bwd(const float* reic_t, const float* relq_t,
                              const float* ice, const float* liq,
                              const float* ct_abi, const float* ct_abl,
                              float* ct_reic, float* ct_relq, int nmax, int L,
                              int B, void* stream) {
    if (nmax < 2 || nmax > MAX_ICE_ROWS) return (int)cudaErrorInvalidValue;
    if (L > 0 && B > 0) {
        dim3 grid((B + THREADS - 1) / THREADS, L);
        cldcoef_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            reic_t, relq_t, ice, liq, ct_abi, ct_abl, ct_reic, ct_relq, nmax,
            B);
    }
    return (int)cudaGetLastError();
}

// reic_t, relq_t (L, B); ice (nmax, 16); liq (58, 16) -> abi, abl (L, 16, B)
RRTM_API int rrtm_cldcoef(const float* reic_t, const float* relq_t,
                          const float* ice, const float* liq, float* abi,
                          float* abl, int nmax, int L, int B, void* stream) {
    if (nmax < 2 || nmax > MAX_ICE_ROWS) return (int)cudaErrorInvalidValue;
    if (L > 0 && B > 0) {
        dim3 grid((B + THREADS - 1) / THREADS, L);
        cldcoef_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            reic_t, relq_t, ice, liq, abi, abl, nmax, B);
    }
    return (int)cudaGetLastError();
}
