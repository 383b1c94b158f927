// K5: the backward of the taumol kernel (K2): cotangents of taug and
// fracs (L, 140, B) -> cotangents of K2's per-cell float inputs
// (NF, L, B), the FLOAT_FIELDS of ops/taumol_cuda.py.
//
// Replaces rrtmg_lw_tpu/ops/taumol_pallas.py::PallasTaumol._build
// kernel_bwd, which ran jax.vjp over the fused setcoef inside the
// kernel and returned the cotangents of 15 profile rows.  The port's K2
// takes setcoef's outputs, so K5 stops at those fields and autograd
// through the plain setcoef finishes the chain (the same total
// derivative).  The TPU workarounds (one-hot selections, bf16 splits,
// 64-row windows) are dropped: rows are gathered directly, in float32.
//
// The linearization is hand-written, term by term, at K2's point: the
// integer bins (jp, jt, jt1, indself, indfor, indminor, laytrop) are
// inputs and every eta bin and clip is recomputed as K2 computes it.
// Discrete choices carry no gradient; where a branch of the plain
// version (torch.where / clamp / minimum) decides which side gets the
// gradient, autograd's convention is kept: the ONEMINUS clamp of
// specparm passes it at x <= ONEMINUS, the over-abundance adjustment
// of a minor gas column only where ratio > threshold.
//
// Bound on the H100: bytes.  Each cell reads 2 x 140 cotangents and
// writes 37 floats; the table reads (L2-resident, as in K2) and ~30
// flops per g-point are cheap beside them.  Design: one thread per
// (column, layer), columns fastest (coalesced), looping over the 16
// bands and their g-points.  The per-field sums over bands live in
// shared memory, acc[field][thread] (no bank conflicts across a warp),
// and are added in band and g order: deterministic, no atomics, and
// no (16, 37, L, B) partials in device memory.
#include "taumol.cuh"

namespace {

using namespace rrtm::taumol;

constexpr int THREADS = 128;

// d spec_weights(specparm, fs) / d fs; specparm enters only through the
// low / high choices.
__device__ __forceinline__ void spec_weights_dfs(float specparm, float fs,
                                                 float* dw) {
    const bool low = specparm < 0.125f;
    const bool high = specparm > 0.875f;
    const float p = low ? fs - 1.0f : -fs;
    const float dp = low ? 1.0f : -1.0f;
    const float dp4 = 4.0f * p * p * p * dp;
    const float dfk0 = dp4;
    const float dfk1 = -dp - 2.0f * dp4;
    const float dfk2 = dp + dp4;
    dw[0] = high ? dfk2 : 0.0f;
    dw[1] = low ? dfk0 : (high ? dfk1 : -1.0f);
    dw[2] = low ? dfk1 : (high ? dfk0 : 1.0f);
    dw[3] = low ? dfk2 : 0.0f;
}

struct Acc {
    float* a;                   // acc[NF][THREADS] in shared memory
    __device__ void add(int f, float v) const { a[f * THREADS] += v; }
};

// Backward of eta_params(c1, c2, rat, scale) given the cotangents of
// speccomb and of fs (js is a truncation: no gradient).  rat_f < 0 for
// a constant ratio.
__device__ __forceinline__ void eta_bwd(const Acc& acc, int f1, int f2,
                                        int rat_f, float c1, float c2,
                                        float rat, float scale, float d_sc,
                                        float d_fs) {
    const float speccomb = c1 + rat * c2;
    const float q = c1 / speccomb;
    float d_c1 = 0.0f;
    if (q <= ONEMINUS_F) {                  // fminf(q, ONEMINUS)
        const float d_q = d_fs * scale;
        d_c1 = d_q / speccomb;
        d_sc = d_sc - d_q * q / speccomb;
    }
    acc.add(f1, d_c1 + d_sc);
    acc.add(f2, d_sc * rat);
    if (rat_f >= 0) acc.add(rat_f, d_sc * c2);
}

__global__ void __launch_bounds__(THREADS)
taumol_bwd_kernel(const float* __restrict__ fld, const int* __restrict__ ifld,
                  const float* __restrict__ T, const int* __restrict__ desc,
                  const float* __restrict__ ct_taug,
                  const float* __restrict__ ct_fracs,
                  float* __restrict__ ct_fld, int L, int B) {
    __shared__ float acc_s[NF * THREADS];
    const int tid = threadIdx.x;
    for (int f = 0; f < NF; ++f) acc_s[f * THREADS + tid] = 0.0f;
    const int b = blockIdx.x * THREADS + tid;
    const int l = blockIdx.y;
    if (b >= B) return;
    const Acc acc{acc_s + tid};
    const size_t LB = (size_t)L * B;
    const size_t cell = (size_t)l * B + b;
    auto F = [&](int f) { return fld[f * LB + cell]; };
    auto I = [&](int f) { return ifld[f * LB + cell]; };

    const bool lower = I(I_LAYTROP) != 0;
    const float scale = lower ? 8.0f : 4.0f;
    const int jp = I(I_JP), jt = I(I_JT), jt1 = I(I_JT1);
    const int indself = I(I_INDSELF), indfor = I(I_INDFOR);
    const int im = I(I_INDMINOR);
    const int im1 = min(im + 1, 18);
    const float fac00 = F(F_FAC00), fac10 = F(F_FAC10);
    const float fac01 = F(F_FAC01), fac11 = F(F_FAC11);
    const float selffac = F(F_SELFFAC), selffrac = F(F_SELFFRAC);
    const float forfac = F(F_FORFAC), forfrac = F(F_FORFRAC);
    const float minorfrac = F(F_MINORFRAC);
    const float coldry = F(F_COLDRY);
    const float pp = F(F_PAVEL);

    for (int band = 0; band < rrtm::NBAND; ++band) {
        const int* D = desc + (band * 2 + (lower ? 0 : 1)) * NDESC;
        if (D[D_ZERO]) continue;            // taug = fracs = 0
        const int ng = D[D_NGB];
        const int nsp = D[D_NSP];
        const size_t g0 = ((size_t)l * rrtm::NGPT + D[D_GOFF]) * B + b;

        // --- key species: the forward's rows and weights, and dw/dfs ---
        const bool has_key = D[D_KEY1] >= 0;
        const bool key2 = has_key && D[D_KEY2] >= 0;
        float colk1 = 0.0f, colk2 = 0.0f, speccomb = 0.0f, speccomb1 = 0.0f;
        float w0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float w1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float dw0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float dw1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        int row0 = 0, row1 = 0, ntap = 0, tap0 = 0;
        if (has_key) {
            colk1 = F(D[D_KEY1]);
            int js0 = 0, js1 = 0;
            float fs = 0.0f, fs1 = 0.0f;
            float specparm = 0.5f, specparm1 = 0.5f;
            if (key2) {
                colk2 = F(D[D_KEY2]);
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
                spec_weights_dfs(specparm, fs, dw0);
                spec_weights_dfs(specparm1, fs1, dw1);
                ntap = 4;
                tap0 = -1;
            } else {
                w0[0] = 1.0f - fs;
                w0[1] = fs;
                w1[0] = 1.0f - fs1;
                w1[1] = fs1;
                dw0[0] = dw1[0] = -1.0f;
                dw0[1] = dw1[1] = 1.0f;
                ntap = 2;
                tap0 = 0;
            }
        }
        const int nrow = D[D_NROW];
        const int toff = max(nsp, 1);

        // --- minor gases: the forward's columns and eta bins ------------
        const int nminor = D[D_NMINOR];
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
                const float colgas = F(adj_gas);
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
            if (M[D_M0_KIND - D_M0_KIND]) {
                const Eta e = eta_params(
                    F(M[D_M0_REF_G1 - D_M0_KIND]),
                    F(M[D_M0_REF_G2 - D_M0_KIND]),
                    bits(M[D_M0_REFRAT - D_M0_KIND]), scale);
                jm0[i] = rrtm::clampi(e.js, 0, M[D_M0_NK - D_M0_KIND] - 2);
                fm[i] = e.fs;
            }
        }
        const int ncfc = D[D_NCFC];
        const int corr_kind = D[D_CORR];
        float corr = 1.0f, dcorr = 0.0f;    // dcorr = d corr / d pavel
        if (corr_kind == 1) {
            if (pp < 250.0f) {
                corr = 1.0f - 0.15f * (250.0f - pp) / 154.4f;
                dcorr = 0.15f / 154.4f;
            }
        } else if (corr_kind == 2) {
            corr = 1.0f - 0.15f * (pp / 95.6f);
            dcorr = -0.15f / 95.6f;
        } else if (corr_kind == 3) {
            corr = 1.0f - 0.05f * (pp - 100.0f) / 900.0f;
            dcorr = -0.05f / 900.0f;
        }
        const int post_off = D[D_POST_OFF];
        const int frac_eta = D[D_FRAC_ETA];
        int jpl0 = 0;
        float fpl = 0.0f;
        if (frac_eta) {
            const Eta e = eta_params(F(D[D_FRAC_G1]), F(D[D_FRAC_G2]),
                                     bits(D[D_FRAC_REFRAT]), scale);
            jpl0 = rrtm::clampi(e.js, 0, D[D_FRAC_NROW] - 2);
            fpl = e.fs;
        }

        // --- per g: the cotangent u of the pre-correction tau, and the
        // sums over g of u times each partial derivative -------------
        float s_sc0 = 0.0f, s_sc1 = 0.0f;
        float s_w0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float s_w1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float s_f00 = 0.0f, s_f10 = 0.0f, s_f01 = 0.0f, s_f11 = 0.0f;
        float s_self = 0.0f, s_selffrac = 0.0f;
        float s_for = 0.0f, s_forfrac = 0.0f;
        float s_colm[MAX_MINORS] = {0.0f, 0.0f, 0.0f};
        float s_fm[MAX_MINORS] = {0.0f, 0.0f, 0.0f};
        float s_minorfrac = 0.0f;
        float s_wx[MAX_CFCS] = {0.0f, 0.0f};
        float s_corr = 0.0f, s_fpl = 0.0f;
        const float* tab = T + D[D_ABS_OFF];
        const int self_off = D[D_SELF_OFF], for_off = D[D_FOR_OFF];
        for (int g = 0; g < ng; ++g) {
            float ct = ct_taug[g0 + (size_t)g * B];
            if (post_off >= 0) ct = ct * T[post_off + g];
            const float u = corr_kind ? corr * ct : ct;
            float tau = 0.0f;                   // before the correction
            if (has_key) {
                float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    if (t >= ntap) break;
                    int r = rrtm::clampi(row0 + tap0 + t, 0, nrow - 1);
                    int rb = rrtm::clampi(r + toff, 0, nrow - 1);
                    float a = tab[r * ng + g], ab = tab[rb * ng + g];
                    float v = fac00 * a + fac10 * ab;
                    acc0 = acc0 + w0[t] * v;
                    s_w0[t] += u * v;
                    s_f00 += u * w0[t] * a;
                    s_f10 += u * w0[t] * ab;
                    r = rrtm::clampi(row1 + tap0 + t, 0, nrow - 1);
                    rb = rrtm::clampi(r + toff, 0, nrow - 1);
                    a = tab[r * ng + g];
                    ab = tab[rb * ng + g];
                    v = fac01 * a + fac11 * ab;
                    acc1 = acc1 + w1[t] * v;
                    s_w1[t] += u * v;
                    s_f01 += u * w1[t] * a;
                    s_f11 += u * w1[t] * ab;
                }
                tau = speccomb * acc0 + speccomb1 * acc1;
                s_sc0 += u * acc0;
                s_sc1 += u * acc1;
            }
            if (self_off >= 0) {
                const float lo = T[self_off + indself * ng + g];
                const float hi = T[self_off + (indself + 1) * ng + g];
                const float v = lo + selffrac * (hi - lo);
                tau = tau + selffac * v;
                s_self += u * v;
                s_selffrac += u * (hi - lo);
            }
            if (for_off >= 0) {
                const float lo = T[for_off + indfor * ng + g];
                const float hi = T[for_off + min(indfor + 1, 3) * ng + g];
                const float v = lo + forfrac * (hi - lo);
                tau = tau + forfac * v;
                s_for += u * v;
                s_forfrac += u * (hi - lo);
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
                    s_minorfrac += u * colm[i] * (a2 - a1);
                    s_fm[i] += u * colm[i] * ((1.0f - minorfrac) * (m10 - m00)
                                              + minorfrac * (m11 - m01));
                } else {
                    const float lo = mt[im * ng + g];
                    const float hi = mt[im1 * ng + g];
                    absm = lo + minorfrac * (hi - lo);
                    s_minorfrac += u * colm[i] * (hi - lo);
                }
                tau = tau + colm[i] * absm;
                s_colm[i] += u * absm;
            }
#pragma unroll
            for (int c = 0; c < MAX_CFCS; ++c) {
                if (c >= ncfc) break;
                const float v = T[D[D_C0_OFF + 2 * c] + g];
                tau = tau + F(D[D_C0_WX + 2 * c]) * v;
                s_wx[c] += u * v;
            }
            s_corr += ct * tau;
            if (frac_eta) {
                const float* ft = T + D[D_FRAC_OFF];
                s_fpl += ct_fracs[g0 + (size_t)g * B]
                         * (ft[(jpl0 + 1) * ng + g] - ft[jpl0 * ng + g]);
            }
        }

        // --- chain the sums back to the fields ------------------------
        if (has_key) {
            acc.add(F_FAC00, speccomb * s_f00);
            acc.add(F_FAC10, speccomb * s_f10);
            acc.add(F_FAC01, speccomb1 * s_f01);
            acc.add(F_FAC11, speccomb1 * s_f11);
            if (key2) {
                float d_fs0 = 0.0f, d_fs1 = 0.0f;
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    d_fs0 += s_w0[t] * dw0[t];
                    d_fs1 += s_w1[t] * dw1[t];
                }
                eta_bwd(acc, D[D_KEY1], D[D_KEY2], D[D_RAT0], colk1, colk2,
                        F(D[D_RAT0]), scale, s_sc0, speccomb * d_fs0);
                eta_bwd(acc, D[D_KEY1], D[D_KEY2], D[D_RAT1], colk1, colk2,
                        F(D[D_RAT1]), scale, s_sc1, speccomb1 * d_fs1);
            } else {
                acc.add(D[D_KEY1], s_sc0 + s_sc1);
            }
        }
        if (self_off >= 0) {
            acc.add(F_SELFFAC, s_self);
            acc.add(F_SELFFRAC, selffac * s_selffrac);
        }
        if (for_off >= 0) {
            acc.add(F_FORFAC, s_for);
            acc.add(F_FORFRAC, forfac * s_forfrac);
        }
        if (nminor > 0) acc.add(F_MINORFRAC, s_minorfrac);
#pragma unroll
        for (int i = 0; i < MAX_MINORS; ++i) {
            if (i >= nminor) break;
            const int* M = D + D_M0_KIND + i * MINOR_WORDS;
            const int adj_gas = M[D_M0_ADJ_GAS - D_M0_KIND];
            if (adj_gas >= 0) {
                const float colgas = F(adj_gas);
                const int chi_off = M[D_M0_ADJ_CHI - D_M0_KIND];
                const float chiref =
                    chi_off >= 0 ? T[chi_off + jp + 1]
                                 : bits(M[D_M0_ADJ_CHICONST - D_M0_KIND]);
                const float den = coldry * chiref;
                const float ratio = 1.0e20f * colgas / den;
                if (ratio > bits(M[D_M0_ADJ_THRESH - D_M0_KIND])) {
                    const float base = bits(M[D_M0_ADJ_BASE - D_M0_KIND]);
                    const float expnt = bits(M[D_M0_ADJ_EXPNT - D_M0_KIND]);
                    const float excess = ratio - base;
                    const float adjfac = base + powf(excess, expnt);
                    // adjcol = adjfac * chiref * coldry * 1e-20
                    const float d_adjfac = s_colm[i] * 1.0e-20f * coldry
                                           * chiref;
                    const float d_ratio =
                        d_adjfac * expnt * powf(excess, expnt - 1.0f);
                    // ratio = 1e20 colgas / den, den = coldry chiref
                    acc.add(adj_gas, d_ratio / den * 1.0e20f);
                    acc.add(F_COLDRY, s_colm[i] * 1.0e-20f * adjfac * chiref
                                      - d_ratio * (ratio / den) * chiref);
                } else {
                    acc.add(adj_gas, s_colm[i]);
                }
            } else {
                const int cola = M[D_M0_COLA - D_M0_KIND];
                const int colb = M[D_M0_COLB - D_M0_KIND];
                if (colb >= 0) {
                    acc.add(cola, s_colm[i] * F(colb));
                    acc.add(colb, s_colm[i] * F(cola));
                } else {
                    acc.add(cola, s_colm[i]);
                }
            }
            if (M[D_M0_KIND - D_M0_KIND])
                eta_bwd(acc, M[D_M0_REF_G1 - D_M0_KIND],
                        M[D_M0_REF_G2 - D_M0_KIND], -1,
                        F(M[D_M0_REF_G1 - D_M0_KIND]),
                        F(M[D_M0_REF_G2 - D_M0_KIND]),
                        bits(M[D_M0_REFRAT - D_M0_KIND]), scale, 0.0f,
                        s_fm[i]);
        }
#pragma unroll
        for (int c = 0; c < MAX_CFCS; ++c)
            if (c < ncfc) acc.add(D[D_C0_WX + 2 * c], s_wx[c]);
        if (corr_kind) acc.add(F_PAVEL, s_corr * dcorr);
        if (frac_eta)
            eta_bwd(acc, D[D_FRAC_G1], D[D_FRAC_G2], -1, F(D[D_FRAC_G1]),
                    F(D[D_FRAC_G2]), bits(D[D_FRAC_REFRAT]), scale, 0.0f,
                    s_fpl);
    }

    for (int f = 0; f < NF; ++f)
        ct_fld[f * LB + cell] = acc_s[f * THREADS + tid];
}

}  // namespace

// fld (NF, L, B) f32, ifld (NI, L, B) i32, tabs, desc as rrtm_taumol;
// ct_taug, ct_fracs (L, 140, B) -> ct_fld (NF, L, B).
RRTM_API int rrtm_taumol_bwd(const float* fld, const int* ifld,
                             const float* tabs, const int* desc,
                             const float* ct_taug, const float* ct_fracs,
                             float* ct_fld, int L, int B, void* stream) {
    if (L > 0 && B > 0) {
        dim3 grid((B + THREADS - 1) / THREADS, L);
        taumol_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            fld, ifld, tabs, desc, ct_taug, ct_fracs, ct_fld, L, B);
    }
    return (int)cudaGetLastError();
}
