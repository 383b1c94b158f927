// Shared by K1 (rtrn_kernel.cuh) and its adjoint K6 (rtrn_bwd.cu): the
// inputs, the factor functions and one step of the sweep recurrences of
// ops/rtrn.py (use_lut=False, the two-division Planck transition), and
// K6's block layout.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "rrtm.cuh"
#include "spec.cuh"

namespace rrtm {
namespace rt {

constexpr int NX = 32;                                  // columns per block
constexpr int NY = 16;                                  // g-lanes per column
constexpr int GPT = (rrtm::NGPT + NY - 1) / NY;         // g-points per thread
constexpr float CLDMIN = 1.0e-20f;
constexpr float REC_6 = 0.166667f;
// a layer holds a per-band cloud where cldfrac >= CLOUD_GATE (banded and
// maxrand modes; rtrn.CLOUD_GATE)
constexpr float CLOUD_GATE = 1.0e-6f;

// K1's modes (rtrn_cuda.MODES): clear sky; compact McICA (mask x layer
// water paths); per-band clouds under random overlap (icld=1); per-band
// clouds under maximum-random overlap (icld 2/3); McICA per-g arrays with
// cldprmc inline (fused, inflag=2); McICA per-g cloud fraction and cloud
// od (cldf-odcld, after cldprmc)
enum Mode { CLEAR = 0, COMPACT = 1, BANDED = 2, MAXRAND = 3, FUSED = 4,
            CLDF_OD = 5 };

// modes whose cloud fraction is per g-point (a layer is cloudy where any
// g of it is, formed by a warp ballot)
__host__ __device__ constexpr bool per_g_clouds(int mode) {
    return mode == COMPACT || mode == FUSED || mode == CLDF_OD;
}

// rows of the (L, 16, B) overlap rows of the maxrand mode
// (rtrnmr.overlap_rows): cldfrac, restart flags of the up and down
// sub-streams, cloud at or above, 6 down factors, 6 up factors
enum Row { R_CLDF = 0, R_IST_UP = 1, R_IST_DN = 2, R_ICLDDN = 3,
           R_DN = 4, R_UP = 10, NROW = 16 };

// rows of the (4, L+1, B) flux output; idrv=1 adds the derivatives of
// the upward fluxes with respect to the surface temperature, (6, L+1, B)
enum Flux { UP = 0, DOWN = 1, CLR_UP = 2, CLR_DOWN = 3, D_UP = 4,
            D_CLR_UP = 5 };

// rtrn._gas_factors: absorptivity and Planck transition, small-od branch
// for od <= 0.06.
__device__ __forceinline__ void gas_factors(float od, float& a, float& tf) {
    if (od <= 0.06f) {
        a = od - 0.5f * od * od;
        tf = REC_6 * od;
    } else {
        const float e = expf(-od);
        a = 1.0f - e;
        tf = 1.0f - 2.0f * (1.0f / od - e / (1.0f - e));
    }
}

// rtrn._tot_factors: the same for gas + cloud, small branch od < 0.06.
__device__ __forceinline__ void tot_factors(float od, float& a, float& tf) {
    if (od < 0.06f) {
        a = od - 0.5f * od * od;
        tf = REC_6 * od;
    } else {
        const float e = expf(-od);
        a = 1.0f - e;
        tf = 1.0f - 2.0f * (1.0f / od - e / (1.0f - e));
    }
}

struct Inputs {
    const float* taut;     // (L, 140, B)
    const float* fracs;    // (L, 140, B)
    const float* play;     // (L, 16, B)
    const float* plev;     // (L+1, 16, B)
    // (3, 16, B): secdiff, semiss, plankbnd; idrv: (4, 16, B), + the
    // temperature derivative of plankbnd
    const float* surf;
    const int8_t* mask;    // (L, 144, B) or null
    const float* cw;       // (L, 2, B): ciwp, clwp
    const float* abi;      // (L, 16, B)
    const float* abl;      // (L, 16, B)
    int L, B;
    // banded: cldfrac (L, B); maxrand: overlap rows (L, 16, B)
    const float* cld = nullptr;
    const float* taucb = nullptr;  // (L, 16, B) cloud od per band
    // per-g McICA arrays (L, 144, B): cloud fraction (fused, cldf-odcld),
    // water paths (fused) and cloud od (fused: the input taucmc;
    // cldf-odcld: cldprmc's output)
    const float* cldf = nullptr;
    const float* ciwp = nullptr;
    const float* clwp = nullptr;
    const float* tauc = nullptr;
};

// K1's inputs in reduced storage (SPEC != SPEC_F32): taut and fracs
// point at taug and fracs in that storage, and the aerosol od (L, 16, B)
// is added to the decoded taug; in float32 (Inputs) taut already holds
// it.  A struct of its own, so that the float32 kernels' parameters stay
// as they were.
struct SpecInputs : Inputs {
    const float* taua = nullptr;
};

template <int SPEC>
using KernelInputs =
    std::conditional_t<SPEC == SPEC_F32, Inputs, SpecInputs>;

// Per (layer, g) factors of one sweep step (rtrn_kernel.cuh staged_step;
// the Planck source is that of the level bounding the step, l for the
// down sweep, l+1 for up).
struct Step {
    float at, atot, ef, cf, src, srctot;
};

// One level of the total-sky stream and its clear twin (rtrn.py
// down_step / up_step).  In a cloudy layer (cly) the cloudy recurrence
// runs for every g of the column; the clear twin follows the clear
// recurrence where `twin` holds and copies the total-sky stream
// elsewhere.  Clear sky is cly = twin = false.
__device__ __forceinline__ void advance(float& rad, float& radc,
                                        const Step& f, bool cly, bool twin) {
    const float gs = f.at * f.src;
    const float rcld = rad - rad * (f.at + f.ef * (1.0f - f.at)) + gs
                       + f.cf * (f.srctot * f.atot - gs);
    const float rclr = rad + (f.src - rad) * f.at;
    const float rn = cly ? rcld : rclr;
    radc = twin ? radc + (f.src - radc) * f.at : rn;
    rad = rn;
}

// One layer of the up sweep's derivatives with respect to the surface
// temperature (idrv=1; rtrn._ddt_step, rtrnmc.f90:495-527): dl through
// the gas transmittance, in a cloudy layer (cly) through the blend of the
// cloudy and clear transmittances with the cloud fraction (every mode,
// maxrand too); the clear twin dc through the gas alone where `twin`
// holds, else dl.
__device__ __forceinline__ void advance_ddt(float& dl, float& dc,
                                            const Step& f, bool cly,
                                            bool twin) {
    const float dn = cly ? dl * f.cf * (1.0f - f.atot)
                               + dl * (1.0f - f.cf) * (1.0f - f.at)
                         : dl * (1.0f - f.at);
    dc = twin ? dc * (1.0f - f.at) : dn;
    dl = dn;
}

// One level of the maximum-random overlap recursion (rtrn._sweep_maxrand,
// rtrnmr.f90:591-615 down, 678-703 up).  In a cloudy layer (cly) the
// total-sky stream is the sum of a cloudy (cr) and a clear (kr)
// sub-stream that exchange a correction radiance (rr), restarted from the
// stream entering the layer where `ist` holds; fac are the layer's six
// overlap factors (clr1, clr2, cld1, cld2, cmb1, cmb2).  Elsewhere the
// clear recurrence runs and the sub-streams keep their values.  The clear
// twin is advance()'s.
__device__ __forceinline__ void advance_mr(float& rad, float& radc,
                                           float& cr, float& kr, float& rr,
                                           const Step& f, bool cly,
                                           bool twin, bool ist,
                                           const float* fac) {
    const float gs = f.at * f.src;
    float rn = rad + (f.src - rad) * f.at;
    if (cly) {
        const float c = f.cf;
        const float cr0 = ist ? c * rad : cr;
        const float kr0 = ist ? rad - c * rad : kr;
        const float rr0 = ist ? 0.0f : rr;
        const float ttot = 1.0f - f.atot;
        const float cldsrc = f.srctot * f.atot;
        const float cr1 = cr0 * ttot + c * cldsrc;
        const float kr1 = kr0 * (1.0f - f.at) + (1.0f - c) * gs;
        const float radmod = rr0 * (fac[0] * (1.0f - f.at) + fac[2] * ttot)
                             - fac[4] * gs + fac[5] * cldsrc;
        const float r = -radmod + fac[1] * (kr1 + radmod)
                        - fac[3] * (cr1 - radmod);
        cr = cr1 + r;
        kr = kr1 - r;
        rr = r;
        rn = cr1 + kr1;
    }
    radc = twin ? radc + (f.src - radc) * f.at : rn;
    rad = rn;
}

}  // namespace rt
}  // namespace rrtm
