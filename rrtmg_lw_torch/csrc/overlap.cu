// The overlap rows of K1's maxrand mode: per column, the maximum-random
// overlap factors between adjacent layers in each sweep direction
// (rrtmg_lw_rtrnmr.f90:347-428 up, :430-506 down) and the flags the
// sub-stream recursion reads.
//
// Replaces the XLA pre-pass of rrtmg_lw_tpu/ops/rtrn_pallas.py::
// rt_maxrandom_pallas (rows16, :1155-1166), which the TPU computes
// with two lax.scan over layers (rtrnmr._overlap_factors_up/_down,
// rrtmg_lw_tpu/ops/rtrnmr.py:33-162).  The spec is
// rtrnmr.overlap_rows: the same elementwise operations in the same
// order, with -fmad=false and IEEE division, so the rows equal the plain
// version's.
//
// Bound on the H100: bytes.  At B=16384, L=60 it reads 4 MB of cloud
// fraction and writes 63 MB of rows: ~0.02 ms at 3.35 TB/s, against
// ~60 flops per (layer, column).  Design: one thread per column,
// sequential over the layers, up pass then down pass, carrying (rat1,
// rat2) in registers.  Row writes coalesce across the warp (columns
// last); the cloud fraction is read (B, L) as the caller holds it, one
// column per thread, from L2.
#include "rtrn.cuh"

namespace {

using namespace rrtm::rt;

__device__ __forceinline__ float safe_div(float a, float b) {
    return a / (b == 0.0f ? 1.0f : b);
}

// One layer of either pass (rtrnmr._overlap_step): nxt is the cloud
// fraction of the layer the sweep goes to, prv of the one it comes from.
// Writes the six factors (clr1, clr2, cld1, cld2, cmb1, cmb2), zero
// where not `live`, and updates (rat1, rat2) where `live`.
__device__ __forceinline__ void overlap_step(float c, float nxt, float prv,
                                             bool ist, bool live,
                                             float& rat1, float& rat2,
                                             float* f) {
    const bool inc = nxt >= c;
    const float fmax = fmaxf(c, prv);
    const float clr2_ist = c < 1.0f ? safe_div(nxt - c, 1.0f - c) : 0.0f;
    const float clr1_e = nxt < fmax ? safe_div(nxt - c, prv - c) : rat2;
    const float clr2_e =
        nxt > fmax ? safe_div(nxt - fmax, 1.0f - fmax) : 0.0f;
    float facclr1 = ist ? 0.0f : clr1_e;
    float facclr2 = ist ? clr2_ist : clr2_e;

    const float fmin = fminf(c, prv);
    const float cld2_ist = safe_div(c - nxt, c);
    const bool le = nxt <= fmin;
    const float cld1_e = le ? rat1 : safe_div(c - nxt, c - fmin);
    const float cld2_e = le ? safe_div(fmin - nxt, fmin) : 0.0f;
    float faccld1 = ist ? 0.0f : cld1_e;
    float faccld2 = ist ? cld2_ist : cld2_e;

    if (inc) {
        faccld1 = faccld2 = 0.0f;
    } else {
        facclr1 = facclr2 = 0.0f;
    }
    const float faccmb1 =
        ist ? 0.0f : fmaxf(fminf(nxt - c, prv - c), 0.0f);
    const float faccmb2 =
        ist ? 0.0f : fmaxf(fminf(c - nxt, c - prv), 0.0f);

    f[0] = live ? facclr1 : 0.0f;
    f[1] = live ? facclr2 : 0.0f;
    f[2] = live ? faccld1 : 0.0f;
    f[3] = live ? faccld2 : 0.0f;
    f[4] = live ? faccmb1 : 0.0f;
    f[5] = live ? faccmb2 : 0.0f;
    if (live) {
        rat1 = inc && (facclr1 > 0.0f || facclr2 > 0.0f) ? 1.0f : 0.0f;
        rat2 = !inc && (faccld1 > 0.0f || faccld2 > 0.0f) ? 1.0f : 0.0f;
    }
}

__global__ void overlap_kernel(const float* __restrict__ cldf,
                               float* __restrict__ rows, int L, int B) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const float* c = cldf + (size_t)b * L;
    auto out = [&](int l, int r) -> float& {
        return rows[((size_t)l * NROW + r) * B + b];
    };
    auto cloudy = [&](int l) { return c[l] >= CLOUD_GATE; };

    // cldfrac, restart flags, cloud at or above (running OR from the top)
    bool above = false;
    for (int l = L - 1; l >= 0; --l) {
        above = above || cloudy(l);
        out(l, R_CLDF) = c[l];
        out(l, R_IST_UP) = (l == 0 || !cloudy(l - 1)) ? 1.0f : 0.0f;
        out(l, R_IST_DN) = (l == L - 1 || !cloudy(l + 1)) ? 1.0f : 0.0f;
        out(l, R_ICLDDN) = above ? 1.0f : 0.0f;
    }
    float f[6];
    // up pass: layer 0 .. L-1; the top layer is never live
    float rat1 = 0.0f, rat2 = 0.0f;
    for (int l = 0; l < L; ++l) {
        const float below = l > 0 ? c[l - 1] : 0.0f;
        const float upper = l < L - 1 ? c[l + 1] : 0.0f;
        const bool ist = l == 0 || !cloudy(l - 1);
        overlap_step(c[l], upper, below, ist, cloudy(l) && l < L - 1, rat1,
                     rat2, f);
#pragma unroll
        for (int i = 0; i < 6; ++i) out(l, R_UP + i) = f[i];
    }
    // down pass: layer L-1 .. 0; the bottom layer is never live
    rat1 = rat2 = 0.0f;
    for (int l = L - 1; l >= 0; --l) {
        const float below = l > 0 ? c[l - 1] : 0.0f;
        const float upper = l < L - 1 ? c[l + 1] : 0.0f;
        const bool ist = l == L - 1 || !cloudy(l + 1);
        overlap_step(c[l], below, upper, ist, cloudy(l) && l > 0, rat1,
                     rat2, f);
#pragma unroll
        for (int i = 0; i < 6; ++i) out(l, R_DN + i) = f[i];
    }
}

}  // namespace

// cldf (B, L) cloud fraction -> rows (L, 16, B) (enum Row).
RRTM_API int rrtm_overlap(const float* cldf, float* rows, int L, int B,
                          void* stream) {
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    const int threads = 128;
    overlap_kernel<<<(B + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(cldf, rows, L, B);
    return (int)cudaGetLastError();
}
