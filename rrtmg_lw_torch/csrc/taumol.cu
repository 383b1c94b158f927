// K2: gaseous optical depth (taug) and Planck fractions for all 16 bands.
//
// Replaces rrtmg_lw_tpu/ops/taumol_pallas.py::PallasTaumol._build.kernel.
// The TPU kernel fused setcoef, selected k-table rows with one-hot
// matmuls over bf16 splits inside 64-row pressure windows, and carried a
// window_ok flag: workarounds for slow gathers.  None of that is kept.
// The spec is the plain TaumolEngine (ops/taumol.py): this kernel reads
// the port's setcoef outputs, packed (NF, L, B) / (NI, L, B), and
// gathers directly from one flat float32 table buffer (~1 MB, resident
// in L2) described per (band, region) by an int32 descriptor that
// ops/taumol_cuda.py::pack_tables compiles from BAND_SPECS.
//
// Bound on the H100: bytes written.  Each cell writes 2 x 140 floats
// (taug, fracs) against ~44 words of inputs and a few hundred L2-cached
// table reads.  Design: one thread per (column, layer, band) looping
// over the band's g-points; columns are the fastest thread index, so
// every input read and every (L, 140, B) store is coalesced.  Blocks of
// one layer run before the next, so a layer's inputs stay in L2 across
// the 16 bands.
//
// Storage (RRTMG_SPEC_DTYPE, spec.cuh): one instantiation per storage
// type; the reduced ones encode each element at the store (the Pallas
// kernel's _enc / write_out, taumol_pallas.py:866-884) and write half
// the bytes.
//
// Index exactness: jp and laytrop come in from setcoef (never a log
// here); the eta bins (trunc of computed floats) use the plain version's
// operation order and the library is built with -fmad=false, so no
// contracted FMA moves a bin.  Every clip of taumol.py:357-417 is kept.
#include <stdint.h>

#include "spec.cuh"
#include "taumol.cuh"

namespace {

using namespace rrtm::taumol;

constexpr int NBIN = 4;         // TaumolEngine.BIN_SLOTS
constexpr int THREADS = 128;

// SPEC: the storage of taug and fracs (spec.cuh); the float32
// instantiation stores as it always did
template <int SPEC>
__global__ void __launch_bounds__(THREADS)
taumol_kernel(const float* __restrict__ fld, const int* __restrict__ ifld,
              const float* __restrict__ T, const int* __restrict__ desc,
              typename rrtm::SpecType<SPEC>::T* __restrict__ taug,
              typename rrtm::SpecType<SPEC>::T* __restrict__ fracs,
              int* __restrict__ bins, int L, int B) {
    using rrtm::spec_enc;
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const int band = blockIdx.y;
    const int l = blockIdx.z;
    if (b >= B) return;
    const size_t LB = (size_t)L * B;
    const size_t cell = (size_t)l * B + b;
    auto F = [&](int f) { return fld[f * LB + cell]; };
    auto I = [&](int f) { return ifld[f * LB + cell]; };

    const bool lower = I(I_LAYTROP) != 0;
    const int* D = desc + (band * 2 + (lower ? 0 : 1)) * NDESC;
    const int ng = D[D_NGB];
    auto* tg = taug + ((size_t)l * rrtm::NGPT + D[D_GOFF]) * B + b;
    auto* fr = fracs + ((size_t)l * rrtm::NGPT + D[D_GOFF]) * B + b;
    int bin_key0 = -1, bin_key1 = -1, bin_frac = -1, bin_minor = -1;

    if (D[D_ZERO]) {
        for (int g = 0; g < ng; ++g) {
            tg[(size_t)g * B] = spec_enc<SPEC, true>(0.0f);
            fr[(size_t)g * B] = spec_enc<SPEC, false>(0.0f);
        }
    } else {
        const float scale = lower ? 8.0f : 4.0f;
        const int nsp = D[D_NSP];
        const int jp = I(I_JP), jt = I(I_JT), jt1 = I(I_JT1);

        // --- key species: rows, eta weights --------------------------
        const bool has_key = D[D_KEY1] >= 0;
        float speccomb = 0.0f, speccomb1 = 0.0f;
        float w0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float w1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        int row0 = 0, row1 = 0, ntap = 0, tap0 = 0;
        if (has_key) {
            const float colk1 = F(D[D_KEY1]);
            int js0 = 0, js1 = 0;
            float fs = 0.0f, fs1 = 0.0f;
            float specparm = 0.5f, specparm1 = 0.5f;
            if (D[D_KEY2] >= 0) {
                const float colk2 = F(D[D_KEY2]);
                const Eta e0 = eta_params(colk1, colk2, F(D[D_RAT0]), scale);
                const Eta e1 = eta_params(colk1, colk2, F(D[D_RAT1]), scale);
                speccomb = e0.speccomb;
                specparm = e0.specparm;
                js0 = e0.js;
                fs = e0.fs;
                speccomb1 = e1.speccomb;
                specparm1 = e1.specparm;
                js1 = e1.js;
                fs1 = e1.fs;
                bin_key0 = js0;
                bin_key1 = js1;
            } else {
                speccomb = speccomb1 = colk1;
            }
            if (lower) {
                row0 = (jp * 5 + jt) * nsp + js0;
                row1 = ((jp + 1) * 5 + jt1) * nsp + js1;
            } else {
                row0 = D[D_NA] + ((jp - 12) * 5 + jt) * nsp + js0;
                row1 = D[D_NA] + ((jp - 11) * 5 + jt1) * nsp + js1;
            }
            if (D[D_ETA4]) {
                spec_weights(specparm, fs, w0);
                spec_weights(specparm1, fs1, w1);
                ntap = 4;
                tap0 = -1;
            } else {
                w0[0] = 1.0f - fs;
                w0[1] = fs;
                w1[0] = 1.0f - fs1;
                w1[1] = fs1;
                ntap = 2;
                tap0 = 0;
            }
        }
        const float fac00 = F(F_FAC00), fac10 = F(F_FAC10);
        const float fac01 = F(F_FAC01), fac11 = F(F_FAC11);
        const int nrow = D[D_NROW];
        const int toff = max(nsp, 1);      // temperature(+1) row stride

        // --- continuum -----------------------------------------------
        const int indself = I(I_INDSELF), indfor = I(I_INDFOR);
        const float selffac = F(F_SELFFAC), selffrac = F(F_SELFFRAC);
        const float forfac = F(F_FORFAC), forfrac = F(F_FORFRAC);

        // --- minor gases: per-cell column and eta bin ------------------
        const int nminor = D[D_NMINOR];
        const int im = I(I_INDMINOR);
        const int im1 = min(im + 1, 18);
        const float minorfrac = F(F_MINORFRAC);
        float colm[MAX_MINORS], fm[MAX_MINORS];
        int jm0[MAX_MINORS];
#pragma unroll
        for (int i = 0; i < MAX_MINORS; ++i) {
            colm[i] = fm[i] = 0.0f;
            jm0[i] = 0;
            if (i >= nminor) continue;
            const int* M = D + D_M0_KIND + i * MINOR_WORDS;
            const int adj_gas = M[D_M0_ADJ_GAS - D_M0_KIND];
            if (adj_gas >= 0) {
                // over-abundance adjustment, chi_mls(gas, jp+1) reference
                const float colgas = F(adj_gas);
                const float coldry = F(F_COLDRY);
                const int chi_off = M[D_M0_ADJ_CHI - D_M0_KIND];
                const float chiref =
                    chi_off >= 0 ? T[chi_off + jp + 1]
                                 : bits(M[D_M0_ADJ_CHICONST - D_M0_KIND]);
                const float ratio = 1.0e20f * colgas / (coldry * chiref);
                const float thresh = bits(M[D_M0_ADJ_THRESH - D_M0_KIND]);
                const float base = bits(M[D_M0_ADJ_BASE - D_M0_KIND]);
                const float expnt = bits(M[D_M0_ADJ_EXPNT - D_M0_KIND]);
                const float excess = ratio > thresh ? ratio - base : 1.0f;
                const float adjfac = base + powf(excess, expnt);
                const float adjcol = adjfac * chiref * coldry * 1.0e-20f;
                colm[i] = ratio > thresh ? adjcol : colgas;
            } else {
                const int colb = M[D_M0_COLB - D_M0_KIND];
                const float cola = F(M[D_M0_COLA - D_M0_KIND]);
                colm[i] = colb >= 0 ? cola * F(colb) : cola;
            }
            if (M[D_M0_KIND - D_M0_KIND]) {          // eta-interpolated
                const Eta e = eta_params(
                    F(M[D_M0_REF_G1 - D_M0_KIND]),
                    F(M[D_M0_REF_G2 - D_M0_KIND]),
                    bits(M[D_M0_REFRAT - D_M0_KIND]), scale);
                jm0[i] = rrtm::clampi(e.js, 0, M[D_M0_NK - D_M0_KIND] - 2);
                fm[i] = e.fs;
                if (bin_minor < 0) bin_minor = jm0[i];
            }
        }

        // --- CFCs, pressure correction, rescale, Planck fractions -------
        const int ncfc = D[D_NCFC];
        float wx[MAX_CFCS];
#pragma unroll
        for (int c = 0; c < MAX_CFCS; ++c)
            wx[c] = c < ncfc ? F(D[D_C0_WX + 2 * c]) : 0.0f;
        const int corr_kind = D[D_CORR];
        const float pp = F(F_PAVEL);
        float corr = 1.0f;
        if (corr_kind == 1)
            corr = pp < 250.0f ? 1.0f - 0.15f * (250.0f - pp) / 154.4f : 1.0f;
        else if (corr_kind == 2)
            corr = 1.0f - 0.15f * (pp / 95.6f);
        else if (corr_kind == 3)
            corr = 1.0f - 0.05f * (pp - 100.0f) / 900.0f;
        const int post_off = D[D_POST_OFF];
        const int frac_eta = D[D_FRAC_ETA];
        int jpl0 = 0;
        float fpl = 0.0f;
        if (frac_eta) {
            const Eta e = eta_params(F(D[D_FRAC_G1]), F(D[D_FRAC_G2]),
                                     bits(D[D_FRAC_REFRAT]), scale);
            jpl0 = rrtm::clampi(e.js, 0, D[D_FRAC_NROW] - 2);
            fpl = e.fs;
            bin_frac = jpl0;
        }

        const float* tab = T + D[D_ABS_OFF];
        const int self_off = D[D_SELF_OFF], for_off = D[D_FOR_OFF];
        for (int g = 0; g < ng; ++g) {
            float tau = 0.0f;
            if (has_key) {
                float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    if (t >= ntap) break;
                    int r = rrtm::clampi(row0 + tap0 + t, 0, nrow - 1);
                    int rb = rrtm::clampi(r + toff, 0, nrow - 1);
                    acc0 = acc0 + w0[t] * (fac00 * tab[r * ng + g]
                                           + fac10 * tab[rb * ng + g]);
                    r = rrtm::clampi(row1 + tap0 + t, 0, nrow - 1);
                    rb = rrtm::clampi(r + toff, 0, nrow - 1);
                    acc1 = acc1 + w1[t] * (fac01 * tab[r * ng + g]
                                           + fac11 * tab[rb * ng + g]);
                }
                tau = speccomb * acc0 + speccomb1 * acc1;
            }
            if (self_off >= 0) {
                const float lo = T[self_off + indself * ng + g];
                const float hi = T[self_off + (indself + 1) * ng + g];
                tau = tau + selffac * (lo + selffrac * (hi - lo));
            }
            if (for_off >= 0) {
                const float lo = T[for_off + indfor * ng + g];
                const float hi = T[for_off + min(indfor + 1, 3) * ng + g];
                tau = tau + forfac * (lo + forfrac * (hi - lo));
            }
#pragma unroll
            for (int i = 0; i < MAX_MINORS; ++i) {
                if (i >= nminor) break;
                const int* M = D + D_M0_KIND + i * MINOR_WORDS;
                const float* mt = T + M[D_M0_OFF - D_M0_KIND];
                float absm;
                if (M[D_M0_KIND - D_M0_KIND]) {
                    const int nk = M[D_M0_NK - D_M0_KIND];
                    const int i00 = im * nk + jm0[i];
                    const int i01 = im1 * nk + jm0[i];
                    const float m00 = mt[i00 * ng + g];
                    const float m10 = mt[(i00 + 1) * ng + g];
                    const float m01 = mt[i01 * ng + g];
                    const float m11 = mt[(i01 + 1) * ng + g];
                    const float a1 = m00 + fm[i] * (m10 - m00);
                    const float a2 = m01 + fm[i] * (m11 - m01);
                    absm = a1 + minorfrac * (a2 - a1);
                } else {
                    const float lo = mt[im * ng + g];
                    const float hi = mt[im1 * ng + g];
                    absm = lo + minorfrac * (hi - lo);
                }
                tau = tau + colm[i] * absm;
            }
#pragma unroll
            for (int c = 0; c < MAX_CFCS; ++c) {
                if (c >= ncfc) break;
                tau = tau + wx[c] * T[D[D_C0_OFF + 2 * c] + g];
            }
            if (corr_kind) tau = corr * tau;
            if (post_off >= 0) tau = tau * T[post_off + g];

            const float* ft = T + D[D_FRAC_OFF];
            float frv;
            if (frac_eta) {
                const float flo = ft[jpl0 * ng + g];
                const float fhi = ft[(jpl0 + 1) * ng + g];
                frv = flo + fpl * (fhi - flo);
            } else {
                frv = ft[g];
            }
            tg[(size_t)g * B] = spec_enc<SPEC, true>(tau);
            fr[(size_t)g * B] = spec_enc<SPEC, false>(frv);
        }
    }

    if (bins != nullptr) {
        const int v[NBIN] = {bin_key0, bin_key1, bin_frac, bin_minor};
#pragma unroll
        for (int s = 0; s < NBIN; ++s)
            bins[((size_t)(band * NBIN + s) * L + l) * B + b] = v[s];
    }
}

template <int SPEC>
void launch(const float* fld, const int* ifld, const float* tabs,
            const int* desc, void* taug, void* fracs, int* bins, int L,
            int B, cudaStream_t s) {
    using T = typename rrtm::SpecType<SPEC>::T;
    dim3 grid((B + THREADS - 1) / THREADS, rrtm::NBAND, L);
    taumol_kernel<SPEC><<<grid, THREADS, 0, s>>>(
        fld, ifld, tabs, desc, static_cast<T*>(taug),
        static_cast<T*>(fracs), bins, L, B);
}

}  // namespace

RRTM_API int rrtm_taumol_ndesc() { return NDESC; }

// fld (NF, L, B) f32; ifld (NI, L, B) i32; tabs flat f32; desc
// (16, 2, NDESC) i32 -> taug, fracs (L, 140, B) in storage `spec`
// (spec.cuh: float32, bfloat16, float16 or logu16 codes); bins
// (16, 4, L, B) i32 or null.
RRTM_API int rrtm_taumol(const float* fld, const int* ifld, const float* tabs,
                         const int* desc, void* taug, void* fracs,
                         int* bins, int L, int B, int spec, void* stream) {
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    switch (spec) {
    case rrtm::SPEC_F32:
        launch<rrtm::SPEC_F32>(fld, ifld, tabs, desc, taug, fracs, bins, L,
                               B, s);
        break;
    case rrtm::SPEC_BF16:
        launch<rrtm::SPEC_BF16>(fld, ifld, tabs, desc, taug, fracs, bins, L,
                                B, s);
        break;
    case rrtm::SPEC_F16:
        launch<rrtm::SPEC_F16>(fld, ifld, tabs, desc, taug, fracs, bins, L,
                               B, s);
        break;
    case rrtm::SPEC_LOGU16:
        launch<rrtm::SPEC_LOGU16>(fld, ifld, tabs, desc, taug, fracs, bins,
                                  L, B, s);
        break;
    default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
