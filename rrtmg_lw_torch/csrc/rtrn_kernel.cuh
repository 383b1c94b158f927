// K1: the longwave radiative-transfer sweep, in six modes: clear sky,
// compact McICA clouds, per-band clouds under random overlap (banded,
// icld=1), per-band clouds under maximum-random overlap (maxrand, icld
// 2/3), McICA per-g arrays with the cloud optics inline (fused) and McICA
// per-g cloud fraction and cloud od (cldf-odcld); each at idrv = 0 or 1.
//
// Replaces rrtmg_lw_tpu/ops/rtrn_pallas.py::_build_kernel.kernel (:140)
// in its clear, compact, banded (:156-157, :285-293, :311-312), maxrand
// (:385-445, :538-598, via rt_maxrandom_pallas :1128), fused (:162-165,
// :328-341) and cldf-odcld (:166-167, :342-343) modes, and its idrv
// outputs (:130, :230-251, :541-553, :585-593, :602-625, :641-654).
// The spec is rtrn.rt_sweep_blocked / rt_sweep_banded / rt_sweep_maxrand
// (use_lut=False) with the two-division Planck transition
// 1 - 2 (1/od - e/(1-e)), not the TPU kernel's one-division form.  The
// TPU's one-hot band -> g expansion and its bf16 three-way split are not
// carried over: a gather by the band of g is exact.
//
// Per column and g-point, the down sweep over levels, surface
// reflection, then the up sweep; radiances are summed over g with the
// weights WTDIFF * delwave(band) * FLUXFAC into up, down, clear up and
// clear down fluxes per level.  With idrv = 1 the up sweep also carries,
// per g, the derivative of the upward radiance with respect to the
// surface temperature and its clear twin, seeded at the surface from
// fracs x dplankbnd_dt (the fourth surface row), and the output gains
// their fluxes as rows 4 and 5; the flux arithmetic and its reduction
// order are those of idrv = 0, so rows 0-3 are bitwise the same.
//
// Bound on the H100: bytes.  At B=16384, L=60 the inputs are ~1.1 GB
// of taut + fracs (L, 140, B), 0.13 GB of Planck sources, plus 0.14 GB
// of int8 mask (compact) or 0.06 GB of per-band cloud od and 4 MB of
// cloud fraction (banded; maxrand adds 0.06 GB of overlap rows), against
// ~30 flops and 1-2 expf per (level, g, column) and sweep: ~1.31 GB,
// ~0.39 ms at 3.35 TB/s (banded), ~1.37 GB, ~0.41 ms (maxrand).  The
// fused and cldf-odcld modes read the (L, 144, B) f32 cloud fraction
// (0.57 GB) and the other per-g arrays only where a g-point is cloudy.
// The up sweep RECOMPUTES the per-level factors from taut instead of
// caching them: a cache of the 6 factors the up sweep needs would write
// and re-read 6 x 4 B per (level, g, column) (~3.3 GB at that shape),
// while recomputing re-reads only taut, fracs and the cloud inputs
// (~1.2 GB) and costs one more expf (two when cloudy) per level.
//
// Design: a block holds 32 columns (one warp across) x 16 g-lanes; each
// thread carries the radiances of 9 of the 140 g-points of its column
// in registers (maxrand: 5 floats per g, the total-sky stream, its clear
// twin, and the cloudy, clear and correction sub-streams; idrv adds 2
// per g in the up sweep).  Reads of (L, G, B) arrays coalesce across the
// warp; the per-column cloud rows are read by every g-lane and served
// from L1.  Per level, the g-weighted radiances are reduced across the
// 16 lanes through shared memory in a fixed order: no atomics on the
// fluxes, and the result is deterministic.
//
// Coupling across g-points: a layer is cloudy for a column when any of
// its g-points has a cloud fraction >= 0.5 (compact, fused, cldf-odcld)
// or where its cloud fraction is >= 1e-6 (banded, maxrand: the same for
// every g).  The clear twin stream of every g follows the cloudy stream
// until the first cloudy layer above (iclddn, down sweep) or anywhere in
// the column (up sweep).  The per-g modes form cloudy_lay per layer with
// a warp ballot OR-ed into shared memory before any g of the layer is
// updated, keep it for the up sweep, and carry iclddn as a running OR
// from the top; the banded mode reads the cloud fraction; the maxrand
// mode reads iclddn, the sub-stream restart flags and the overlap factors
// from the rows the overlap kernel (overlap.cu) made.
//
// Storage (RRTMG_SPEC_DTYPE): a third template parameter, SPEC
// (spec.cuh), reads taut and fracs in float32 (taua already added by the
// model) or as bf16, f16 or logu16 codes, decoded at each read
// (rtrn_pallas.py:234, :259-261, :499), with the aerosol od of the band
// added to the decoded taug inside the kernel (:263-275).  16-bit storage
// halves the bytes of taut and fracs, read twice (down and up sweep).
// rtrn.cu instantiates the float32 kernels and holds the entry point;
// rtrn_bf16.cu, rtrn_f16.cu and rtrn_logu16.cu the reduced ones, one
// translation unit each so that nvcc builds them in parallel.
#pragma once

#include "rtrn.cuh"

namespace rrtm {
namespace rt {

// K1 in reduced storage, each defined in its own translation unit;
// taua (L, 16, B) the aerosol od
cudaError_t launch_bf16(const Inputs& in, const float* taua, const int* ngb,
                        const float* wg, float* out, int mode, int idrv,
                        cudaStream_t s);
cudaError_t launch_f16(const Inputs& in, const float* taua, const int* ngb,
                       const float* wg, float* out, int mode, int idrv,
                       cudaStream_t s);
cudaError_t launch_logu16(const Inputs& in, const float* taua,
                          const int* ngb, const float* wg, float* out,
                          int mode, int idrv, cudaStream_t s);

}  // namespace rt
}  // namespace rrtm

namespace {

using namespace rrtm::rt;

// Sum the g-lanes' partial fluxes s[i] of each column in a fixed order
// and write them to flux rows r0, r1 (, r2, r3) of out at level `lev`,
// lane i summing s[i].
template <int N>
__device__ __forceinline__ void reduce_write(float (*part)[NY][NX],
                                             const float (&s)[N], int r0,
                                             int r1, int r2, int r3,
                                             float* out, int lev, int L,
                                             int B, int b, bool valid) {
    const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
    for (int i = 0; i < N; ++i) part[i][ty][tx] = s[i];
    __syncthreads();
    if (ty < N && valid) {
        const int r = ty == 0 ? r0 : ty == 1 ? r1 : ty == 2 ? r2 : r3;
        float acc = 0.0f;
#pragma unroll
        for (int y = 0; y < NY; ++y) acc += part[ty][y][tx];
        out[((size_t)r * (L + 1) + lev) * B + b] = acc;
    }
    __syncthreads();
}

template <int MODE, bool IDRV, int SPEC>
__global__ void __launch_bounds__(NX * NY)
rt_kernel(KernelInputs<SPEC> in, const int* __restrict__ ngb,
          const float* __restrict__ wg, float* __restrict__ out) {
    constexpr bool MR = MODE == MAXRAND;
    constexpr bool PERG = per_g_clouds(MODE);
    constexpr int NSUB = MR ? GPT : 1;     // sub-stream carries (maxrand)
    constexpr int ND = IDRV ? GPT : 1;     // d/dT carries (idrv)
    constexpr int NUP = IDRV ? 4 : 2;      // flux rows of the up sweep
    extern __shared__ unsigned int cly_bits[];   // (L,) column bitmasks
    __shared__ float part[NUP][NY][NX];
    __shared__ int ngb_s[rrtm::NGPT];
    __shared__ float wg_s[rrtm::NGPT];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * NX + tx;
    const int L = in.L, B = in.B;
    for (int i = tid; i < rrtm::NGPT; i += NX * NY) {
        ngb_s[i] = ngb[i];
        wg_s[i] = wg[i];
    }
    if (PERG)
        for (int i = tid; i < L; i += NX * NY) cly_bits[i] = 0u;
    __syncthreads();

    const int b0 = blockIdx.x * NX + tx;
    const bool valid = b0 < B;
    const int b = valid ? b0 : B - 1;      // ragged edge: compute, never write

    int bnd[GPT];
    float secd[GPT], rad[GPT], radc[GPT], m[GPT];
    float cr[NSUB], kr[NSUB], rr[NSUB], dl[ND], dc[ND];
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
        const int g = ty + k * NY;
        bnd[k] = g < rrtm::NGPT ? ngb_s[g] : 0;
        secd[k] = in.surf[(size_t)bnd[k] * B + b];
        rad[k] = radc[k] = m[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < NSUB; ++k) cr[k] = kr[k] = rr[k] = 0.0f;
    // maxrand: one (L, 16, B) row of this column at layer l
    auto row = [&](int l, int r) {
        return in.cld[((size_t)l * NROW + r) * B + b];
    };

    // ---- down sweep: layer L-1 .. 0, radiance at each layer bottom ----
    bool icl = false;                      // cloud in path above (iclddn)
    for (int l = L - 1; l >= 0; --l) {
        bool cly = false, ist = false;
        float cw0 = 0.0f, cw1 = 0.0f, cf = 0.0f, fac[6];
        if (PERG) {
            bool mine = false;
#pragma unroll
            for (int k = 0; k < GPT; ++k) {
                const int g = ty + k * NY;
                if (g < rrtm::NGPT) {
                    m[k] = g_cloud_fraction<MODE>(in, l, g, b);
                    mine |= m[k] >= 0.5f;
                }
            }
            const unsigned bal = __ballot_sync(0xffffffffu, mine && valid);
            if (tx == 0 && bal) atomicOr(&cly_bits[l], bal);
            if (MODE == COMPACT) {
                cw0 = in.cw[((size_t)l * 2) * B + b];
                cw1 = in.cw[((size_t)l * 2 + 1) * B + b];
            }
            __syncthreads();
            cly = (cly_bits[l] >> tx) & 1u;
            icl = icl || cly;
        } else if (MODE == BANDED) {
            cf = in.cld[(size_t)l * B + b];
            cly = cf >= CLOUD_GATE;
            icl = icl || cly;
        } else if (MR) {
            cf = row(l, R_CLDF);
            cly = cf >= CLOUD_GATE;
            icl = row(l, R_ICLDDN) > 0.0f;
            ist = row(l, R_IST_DN) > 0.0f;
#pragma unroll
            for (int i = 0; i < 6; ++i) fac[i] = row(l, R_DN + i);
        }
        float s[2] = {0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int g = ty + k * NY;
            if (g >= rrtm::NGPT) continue;
            const Step f = layer_step<MODE, SPEC>(in, l, l, g, bnd[k],
                                                  secd[k], PERG ? m[k] : cf,
                                                  cw0, cw1, b);
            if (MR)
                advance_mr(rad[k], radc[k], cr[k % NSUB], kr[k % NSUB],
                           rr[k % NSUB], f, cly, icl, ist, fac);
            else
                advance(rad[k], radc[k], f, cly, icl);
            s[0] += wg_s[g] * rad[k];
            s[1] += wg_s[g] * radc[k];
        }
        reduce_write(part, s, DOWN, CLR_DOWN, 0, 0, out, l, L, B, b0, valid);
    }
    if (ty < 2 && valid) {                 // nothing comes down at the top
        const int r = ty == 0 ? DOWN : CLR_DOWN;
        out[((size_t)r * (L + 1) + L) * B + b0] = 0.0f;
    }

    // ---- surface reflection (and the d/dT seed) ----
    {
        float s[NUP] = {};
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int g = ty + k * NY;
            if (g >= rrtm::NGPT) continue;
            const float fr0 =
                rrtm::spec_load<SPEC, false>(in.fracs, (size_t)g * B + b);
            const float rad0 =
                fr0 * in.surf[((size_t)2 * rrtm::NBAND + bnd[k]) * B + b];
            const float reflect =
                1.0f - in.surf[((size_t)rrtm::NBAND + bnd[k]) * B + b];
            rad[k] = rad0 + reflect * rad[k];
            radc[k] = rad0 + reflect * radc[k];
            s[0] += wg_s[g] * rad[k];
            s[1] += wg_s[g] * radc[k];
            if constexpr (IDRV) {
                const float d0 =
                    fr0 * in.surf[((size_t)3 * rrtm::NBAND + bnd[k]) * B + b];
                dl[k] = dc[k] = d0;
                s[2] += wg_s[g] * d0;
                s[3] += wg_s[g] * d0;
            }
        }
        reduce_write(part, s, UP, CLR_UP, D_UP, D_CLR_UP, out, 0, L, B, b0,
                     valid);
    }
#pragma unroll
    for (int k = 0; k < NSUB; ++k) cr[k] = kr[k] = rr[k] = 0.0f;

    // ---- up sweep: layer 0 .. L-1, radiance at each layer top ----
    // any cloudy layer in the column: maxrand reads iclddn of layer 0
    const bool anyc = MR ? row(0, R_ICLDDN) > 0.0f : icl;
    for (int l = 0; l < L; ++l) {
        bool cly = false, ist = false;
        float cw0 = 0.0f, cw1 = 0.0f, cf = 0.0f, fac[6];
        if (PERG) {
            cly = (cly_bits[l] >> tx) & 1u;
#pragma unroll
            for (int k = 0; k < GPT; ++k) {
                const int g = ty + k * NY;
                if (g < rrtm::NGPT) m[k] = g_cloud_fraction<MODE>(in, l, g, b);
            }
            if (MODE == COMPACT) {
                cw0 = in.cw[((size_t)l * 2) * B + b];
                cw1 = in.cw[((size_t)l * 2 + 1) * B + b];
            }
        } else if (MODE == BANDED) {
            cf = in.cld[(size_t)l * B + b];
            cly = cf >= CLOUD_GATE;
        } else if (MR) {
            cf = row(l, R_CLDF);
            cly = cf >= CLOUD_GATE;
            ist = row(l, R_IST_UP) > 0.0f;
#pragma unroll
            for (int i = 0; i < 6; ++i) fac[i] = row(l, R_UP + i);
        }
        float s[NUP] = {};
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int g = ty + k * NY;
            if (g >= rrtm::NGPT) continue;
            const Step f = layer_step<MODE, SPEC>(in, l, l + 1, g, bnd[k],
                                                  secd[k], PERG ? m[k] : cf,
                                                  cw0, cw1, b);
            if (MR)
                advance_mr(rad[k], radc[k], cr[k % NSUB], kr[k % NSUB],
                           rr[k % NSUB], f, cly, anyc, ist, fac);
            else
                advance(rad[k], radc[k], f, cly, anyc);
            s[0] += wg_s[g] * rad[k];
            s[1] += wg_s[g] * radc[k];
            if constexpr (IDRV) {
                advance_ddt(dl[k], dc[k], f, cly, anyc);
                s[2] += wg_s[g] * dl[k];
                s[3] += wg_s[g] * dc[k];
            }
        }
        reduce_write(part, s, UP, CLR_UP, D_UP, D_CLR_UP, out, l + 1, L, B,
                     b0, valid);
    }
}

template <int MODE, bool IDRV, int SPEC>
cudaError_t launch(const KernelInputs<SPEC>& in, const int* ngb,
                   const float* wg, float* out, cudaStream_t s) {
    const dim3 block(NX, NY);
    const dim3 grid((in.B + NX - 1) / NX);
    const size_t smem =
        per_g_clouds(MODE) ? (size_t)in.L * sizeof(unsigned int) : 0;
    if (smem > 32 * 1024) {       // with the static arrays, past 48 KB
        cudaError_t e = cudaFuncSetAttribute(
            rt_kernel<MODE, IDRV, SPEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    rt_kernel<MODE, IDRV, SPEC><<<grid, block, smem, s>>>(in, ngb, wg, out);
    return cudaGetLastError();
}

template <int MODE, int SPEC>
cudaError_t launch(const KernelInputs<SPEC>& in, const int* ngb,
                   const float* wg, float* out, int idrv, cudaStream_t s) {
    return idrv ? launch<MODE, true, SPEC>(in, ngb, wg, out, s)
                : launch<MODE, false, SPEC>(in, ngb, wg, out, s);
}

// K1 in `mode` (enum Mode) with taut / fracs in storage SPEC; checks
// that the mode's cloud inputs (and, in reduced storage, taua) are given
template <int SPEC>
cudaError_t launch_storage(const Inputs& inputs, const float* taua,
                           const int* ngb, const float* wg, float* out,
                           int mode, int idrv, cudaStream_t s) {
    KernelInputs<SPEC> in;
    static_cast<Inputs&>(in) = inputs;
    if constexpr (SPEC != rrtm::SPEC_F32) {
        if (!taua) return cudaErrorInvalidValue;
        in.taua = taua;
    }
    switch (mode) {
    case CLEAR:
        return launch<CLEAR, SPEC>(in, ngb, wg, out, idrv, s);
    case COMPACT:
        if (!in.mask || !in.cw || !in.abi || !in.abl)
            return cudaErrorInvalidValue;
        return launch<COMPACT, SPEC>(in, ngb, wg, out, idrv, s);
    case BANDED:
        if (!in.cld || !in.taucb) return cudaErrorInvalidValue;
        return launch<BANDED, SPEC>(in, ngb, wg, out, idrv, s);
    case MAXRAND:
        if (!in.cld || !in.taucb) return cudaErrorInvalidValue;
        return launch<MAXRAND, SPEC>(in, ngb, wg, out, idrv, s);
    case FUSED:
        if (!in.cldf || !in.ciwp || !in.clwp || !in.tauc || !in.abi
            || !in.abl)
            return cudaErrorInvalidValue;
        return launch<FUSED, SPEC>(in, ngb, wg, out, idrv, s);
    case CLDF_OD:
        if (!in.cldf || !in.tauc) return cudaErrorInvalidValue;
        return launch<CLDF_OD, SPEC>(in, ngb, wg, out, idrv, s);
    default:
        return cudaErrorInvalidValue;
    }
}

}  // namespace
