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
// 64-row windows and their window_ok flag) stay dropped: on the H100 a
// gather from the ~1 MB table set (L2-resident) is native, so rows are
// read directly, in float32.
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
// Bound on the H100: bytes.  Each cell reads 2 x 140 cotangents and 44
// input words and writes 37 floats (0.42 ms at B=16384, L=60); its ~87
// float operations per (cell, g-point) (chip_smoke.py counts them per
// band) take 0.18 ms at the f32 peak.  The first design (one thread per
// (column, layer), every descriptor word read and branched on at run
// time, 168 registers, 3 blocks per SM: K2's first design) spent its
// time issuing instructions (-fmad=false: an add and a multiply are two)
// and waiting on gathers.  This is K2's design, then cut to what the
// card's occupancy needs:
//   * one block per (TB = 128 columns, layer), columns the fastest index
//     (every cotangent row read and every output row written coalesced);
//     the tile's NF float and NI int input rows (the ints as 16-bit:
//     setcoef's bins are below 60) are staged in shared memory first, so
//     a cell's inputs leave device memory once, not once per band;
//   * each thread walks its column's 16 bands (bands_from_bwd), each
//     (band, region)'s structure compiled in from the Shape tables of
//     taumol.cuh (field indices, tap counts, nsp, which terms are there,
//     ng); table offsets, nrow / na / nk and the float constants still
//     come from the descriptor (read where used: the same words for every
//     thread, from L1), and the wrapper holds its structure words to the
//     compiled ones;
//   * per (cell, band), each term's setup runs once, before its g-loop:
//     a key row's taps' clamped rows and weights, the continuum, minor,
//     CFC and fraction rows; d w / d fs and the eta terms the chain-back
//     needs are made again after it rather than kept;
//   * the terms take their g-loops one after the other (the key species
//     one pressure row a loop), each built for the band's ng and stepping
//     VW = 2 g-points, a table row read 8 bytes a load (pack_tables
//     starts every table on 8 bytes), two cotangent rows a step; the
//     fraction's row rides on the first loop; only bands 1-2, whose
//     pressure correction sums tau over all terms, take one loop;
//   * the per-field sums over bands live in shared memory, acc[f][thread]
//     (no bank conflicts across a warp), and leave in one coalesced store
//     per field.
// Registers and shared memory: 96 registers a thread, no spill, and
// 4 x (NF x TB) x 2 (inputs, sums) + 2 x NI x TB = 18,944 x 2 + 1,792 =
// 39,680 B a block: MIN_BLOCKS = 5 blocks of 128 threads fit an SM.
// Measured on the H100 (utils/k5_variants.py; PERF.md): the staged
// descriptors (8,960 B more, 4 blocks) ran 1.65 ms, these 5 blocks
// 1.45, and 6 blocks (80 registers, the int inputs out of shared
// memory) 1.24 but spilled.
//
// Bitwise the first design: every running sum takes its terms in the
// same order and with the same expression shapes (g ascending inside a
// band, key taps t = 0..3, self, foreign, minors in order, CFCs; bands
// ascending; the chain-back adds in the order below), and the library
// is built with -fmad=false, so neither K2's eta bins nor any sum moves.
#include <stdint.h>

#include "taumol.cuh"

namespace {

using namespace rrtm::taumol;

constexpr int TB = 128;         // columns per block, one thread each
constexpr int THREADS = TB;
constexpr int MIN_BLOCKS = 5;   // per SM, for __launch_bounds__
constexpr int TAB_ALIGN = 2;    // floats: pack_tables' table alignment
constexpr int VW = 2;           // floats a row load

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

// one column's per-field sums, a[f * TB] in shared memory
struct Acc {
    float* a;
    __device__ void add(int f, float v) const { a[f * TB] += v; }
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

// the array a (R = 0) or b (R = 1)
template <int R, typename X>
__device__ __forceinline__ X& pick(X& a, X& b) {
    if constexpr (R == 0) return a;
    else return b;
}

// One cell of band BAND in region REGION (0 lower, 1 upper): the
// region's run-time descriptor D (device memory); the cell's fields at
// fin[f * TB], iin[f * TB]; the cotangents of its taug and fracs at
// ctg[g * B], ctf[g * B]; its field sums in acc.
//
// Each term of tau (key species, continuum, minor gases, CFCs) and the
// fraction's eta row has its setup, its sums over g and its chain-back.
// Where the pressure correction applies (bands 1-2, whose s_corr sums
// tau over all terms) every setup runs, then one pass over g, then every
// chain-back; elsewhere one term at a time (the key species one pressure
// row a pass), so few values are live at once.  Either way each sum
// takes its terms in the same order (g ascending; key taps, self,
// foreign, minors, CFCs within a g), and the field sums theirs in the
// chain-back's order.
template <int BAND, int REGION>
__device__ __forceinline__ void cell_band_bwd(const int* D, const float* fin,
                                              const short* iin,
                                              const float* T,
                                              const float* ctg,
                                              const float* ctf, size_t B,
                                              const Acc& acc) {
    auto F = [&](int f) { return fin[f * TB]; };
    auto I = [&](int f) { return (int)iin[f * TB]; };
    constexpr int NG = sw<BAND, REGION>(D_NGB);
    static_assert(NG % VW == 0, "rows are read VW floats a load");

    if constexpr (sw<BAND, REGION>(D_ZERO) != 0) {
        return;                             // taug = fracs = 0
    } else {
    constexpr bool LOWER = REGION == 0;
    const float scale = LOWER ? 8.0f : 4.0f;
    constexpr int NSP = sw<BAND, REGION>(D_NSP);
    constexpr int KEY1 = sw<BAND, REGION>(D_KEY1);
    constexpr int KEY2 = sw<BAND, REGION>(D_KEY2);
    constexpr int RAT0 = sw<BAND, REGION>(D_RAT0);
    constexpr int RAT1 = sw<BAND, REGION>(D_RAT1);
    static_assert(KEY2 < 0 || (KEY1 >= 0 && RAT0 >= 0 && RAT1 >= 0),
                  "a second key species comes with the first and ratios");
    constexpr bool ETA4 = sw<BAND, REGION>(D_ETA4) != 0;
    constexpr int NTAP = ETA4 ? 4 : 2;
    constexpr bool SELF = sw<BAND, REGION>(D_SELF_OFF) >= 0;
    constexpr bool FOR = sw<BAND, REGION>(D_FOR_OFF) >= 0;
    constexpr int NMINOR = sw<BAND, REGION>(D_NMINOR);
    static_assert(MAX_MINORS == 3, "three calls per minor step");
    constexpr int NCFC = sw<BAND, REGION>(D_NCFC);
    static_assert(MAX_CFCS == 2, "two CFC words");
    constexpr int CORR = sw<BAND, REGION>(D_CORR);
    constexpr bool POST = sw<BAND, REGION>(D_POST_OFF) >= 0;
    constexpr bool FRAC_ETA = sw<BAND, REGION>(D_FRAC_ETA) != 0;

    // --- the cotangents of g and g + 1 after the rescale (ct), and u,
    // that of the pre-correction tau -----------------------------------
    float corr = 1.0f, dcorr = 0.0f;        // dcorr = d corr / d pavel
    if constexpr (CORR == 1) {
        const float pp = F(F_PAVEL);
        if (pp < 250.0f) {
            corr = 1.0f - 0.15f * (250.0f - pp) / 154.4f;
            dcorr = 0.15f / 154.4f;
        }
    } else if constexpr (CORR == 2) {
        const float pp = F(F_PAVEL);
        corr = 1.0f - 0.15f * (pp / 95.6f);
        dcorr = -0.15f / 95.6f;
    } else if constexpr (CORR == 3) {
        const float pp = F(F_PAVEL);
        corr = 1.0f - 0.05f * (pp - 100.0f) / 900.0f;
        dcorr = -0.05f / 900.0f;
    }
    const int post_off = POST ? D[D_POST_OFF] : 0;
    auto cotangents = [&](int g, float* ct, float* u) {
#pragma unroll
        for (int v = 0; v < VW; ++v) ct[v] = ctg[(size_t)(g + v) * B];
        if constexpr (POST) {
            float x[VW];
            load_row(T + post_off + g, x);
#pragma unroll
            for (int v = 0; v < VW; ++v) ct[v] = ct[v] * x[v];
        }
#pragma unroll
        for (int v = 0; v < VW; ++v) u[v] = CORR != 0 ? corr * ct[v] : ct[v];
    };

    // --- key species: before the pass of pressure row ROW (0: jp, 1:
    // jp + 1), its eta terms, its taps' clipped rows and weights --------
    float speccomb = 0.0f, speccomb1 = 0.0f;
    float fac00 = 0.0f, fac10 = 0.0f, fac01 = 0.0f, fac11 = 0.0f;
    float w0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float w1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int k0[4] = {0, 0, 0, 0}, kb0[4] = {0, 0, 0, 0};
    int k1[4] = {0, 0, 0, 0}, kb1[4] = {0, 0, 0, 0};
    float s_sc0 = 0.0f, s_sc1 = 0.0f;
    float s_w0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float s_w1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float s_f00 = 0.0f, s_f10 = 0.0f, s_f01 = 0.0f, s_f11 = 0.0f;
    auto key_row_setup = [&](auto row) {
        constexpr int ROW = decltype(row)::value;
        const int jp = I(I_JP), jt = I(ROW == 0 ? I_JT : I_JT1);
        const float colk1 = F(KEY1);
        float& sc = pick<ROW>(speccomb, speccomb1);
        int js = 0;
        float specparm = 0.5f, fs = 0.0f;
        if constexpr (KEY2 >= 0) {
            const Eta e = eta_params(colk1, F(KEY2), F(ROW == 0 ? RAT0 : RAT1),
                                     scale);
            sc = e.speccomb;
            specparm = e.specparm;
            js = e.js;
            fs = e.fs;
        } else {
            sc = colk1;
        }
        int krow;
        if constexpr (LOWER)
            krow = ((jp + ROW) * 5 + jt) * NSP + js;
        else
            krow = D[D_NA] + ((jp - 12 + ROW) * 5 + jt) * NSP + js;
        auto& w = pick<ROW>(w0, w1);
        auto& k = pick<ROW>(k0, k1);
        auto& kb = pick<ROW>(kb0, kb1);
        int tap0;
        if constexpr (ETA4) {
            spec_weights(specparm, fs, w);
            tap0 = -1;
        } else {
            w[0] = 1.0f - fs;
            w[1] = fs;
            tap0 = 0;
        }
        const int nrow = D[D_NROW];
        constexpr int TOFF = NSP > 1 ? NSP : 1;  // temperature(+1) stride
        const int abs_off = D[D_ABS_OFF];
#pragma unroll
        for (int t = 0; t < NTAP; ++t) {
            const int r = rrtm::clampi(krow + tap0 + t, 0, nrow - 1);
            k[t] = abs_off + r * NG;
            kb[t] = abs_off + rrtm::clampi(r + TOFF, 0, nrow - 1) * NG;
        }
        pick<ROW>(fac00, fac01) = F(ROW == 0 ? F_FAC00 : F_FAC01);
        pick<ROW>(fac10, fac11) = F(ROW == 0 ? F_FAC10 : F_FAC11);
    };
    // pressure row ROW of g and g + 1: its taps' rows at the reference
    // temperature and the next, its sums, and acc_r[v] (its share of tau
    // before speccomb)
    auto key_row = [&](auto row, int g, const float* u, float* acc_r) {
        constexpr int ROW = decltype(row)::value;
        const auto& k = pick<ROW>(k0, k1);
        const auto& kb = pick<ROW>(kb0, kb1);
        const auto& w = pick<ROW>(w0, w1);
        const float fa = pick<ROW>(fac00, fac01);
        const float fb = pick<ROW>(fac10, fac11);
        auto& s_w = pick<ROW>(s_w0, s_w1);
        float& s_fa = pick<ROW>(s_f00, s_f01);
        float& s_fb = pick<ROW>(s_f10, s_f11);
        float& s_sc = pick<ROW>(s_sc0, s_sc1);
        float a[NTAP][VW], b[NTAP][VW];
#pragma unroll
        for (int t = 0; t < NTAP; ++t) {
            load_row(T + k[t] + g, a[t]);
            load_row(T + kb[t] + g, b[t]);
        }
#pragma unroll
        for (int v = 0; v < VW; ++v) {
            acc_r[v] = 0.0f;
#pragma unroll
            for (int t = 0; t < NTAP; ++t) {
                const float p = fa * a[t][v] + fb * b[t][v];
                acc_r[v] = acc_r[v] + w[t] * p;
                s_w[t] += u[v] * p;
                s_fa += u[v] * w[t] * a[t][v];
                s_fb += u[v] * w[t] * b[t][v];
            }
            s_sc += u[v] * acc_r[v];
        }
    };
    // the key sums back to the fields; speccomb and d w / d fs from the
    // setup's eta terms made again (fewer values live through the passes)
    auto key_back = [&] {
        const float colk1 = F(KEY1);
        float sc0 = colk1, sc1 = colk1;
        float dw0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float dw1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float colk2 = 0.0f;
        if constexpr (KEY2 >= 0) {
            colk2 = F(KEY2);
            const Eta e0 = eta_params(colk1, colk2, F(RAT0), scale);
            const Eta e1 = eta_params(colk1, colk2, F(RAT1), scale);
            sc0 = e0.speccomb;
            sc1 = e1.speccomb;
            if constexpr (ETA4) {
                spec_weights_dfs(e0.specparm, e0.fs, dw0);
                spec_weights_dfs(e1.specparm, e1.fs, dw1);
            } else {
                dw0[0] = dw1[0] = -1.0f;
                dw0[1] = dw1[1] = 1.0f;
            }
        }
        acc.add(F_FAC00, sc0 * s_f00);
        acc.add(F_FAC10, sc0 * s_f10);
        acc.add(F_FAC01, sc1 * s_f01);
        acc.add(F_FAC11, sc1 * s_f11);
        if constexpr (KEY2 >= 0) {
            float d_fs0 = 0.0f, d_fs1 = 0.0f;
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                d_fs0 += s_w0[t] * dw0[t];
                d_fs1 += s_w1[t] * dw1[t];
            }
            eta_bwd(acc, KEY1, KEY2, RAT0, colk1, colk2, F(RAT0), scale,
                    s_sc0, sc0 * d_fs0);
            eta_bwd(acc, KEY1, KEY2, RAT1, colk1, colk2, F(RAT1), scale,
                    s_sc1, sc1 * d_fs1);
        } else {
            acc.add(KEY1, s_sc0 + s_sc1);
        }
    };

    // --- continuum -----------------------------------------------------
    float selffac = 0.0f, selffrac = 0.0f, forfac = 0.0f, forfrac = 0.0f;
    int s_lo = 0, s_hi = 0, f_lo = 0, f_hi = 0;
    float s_self = 0.0f, s_selffrac = 0.0f;
    float s_for = 0.0f, s_forfrac = 0.0f;
    auto cont_setup = [&] {
        if constexpr (SELF) {
            const int self_off = D[D_SELF_OFF], indself = I(I_INDSELF);
            selffac = F(F_SELFFAC);
            selffrac = F(F_SELFFRAC);
            s_lo = self_off + indself * NG;
            s_hi = self_off + (indself + 1) * NG;
        }
        if constexpr (FOR) {
            const int for_off = D[D_FOR_OFF], indfor = I(I_INDFOR);
            forfac = F(F_FORFAC);
            forfrac = F(F_FORFRAC);
            f_lo = for_off + indfor * NG;
            f_hi = for_off + min(indfor + 1, 3) * NG;
        }
    };
    auto cont_step = [&](int g, const float* u, float* tau) {
        float x[VW], y[VW];
        if constexpr (SELF) {
            load_row(T + s_lo + g, x);
            load_row(T + s_hi + g, y);
#pragma unroll
            for (int v = 0; v < VW; ++v) {
                const float p = x[v] + selffrac * (y[v] - x[v]);
                tau[v] = tau[v] + selffac * p;
                s_self += u[v] * p;
                s_selffrac += u[v] * (y[v] - x[v]);
            }
        }
        if constexpr (FOR) {
            load_row(T + f_lo + g, x);
            load_row(T + f_hi + g, y);
#pragma unroll
            for (int v = 0; v < VW; ++v) {
                const float p = x[v] + forfrac * (y[v] - x[v]);
                tau[v] = tau[v] + forfac * p;
                s_for += u[v] * p;
                s_forfrac += u[v] * (y[v] - x[v]);
            }
        }
    };
    auto cont_back = [&] {
        if constexpr (SELF) {
            acc.add(F_SELFFAC, s_self);
            acc.add(F_SELFFRAC, selffac * s_selffrac);
        }
        if constexpr (FOR) {
            acc.add(F_FORFAC, s_for);
            acc.add(F_FORFRAC, forfac * s_forfrac);
        }
    };

    // --- minor gases: the forward's columns, rows and eta bins ---------
    float minorfrac = 0.0f;
    float colm[MAX_MINORS] = {0.0f, 0.0f, 0.0f};
    float fm[MAX_MINORS] = {0.0f, 0.0f, 0.0f};
    int ma[MAX_MINORS] = {0, 0, 0}, mb[MAX_MINORS] = {0, 0, 0};
    float s_colm[MAX_MINORS] = {0.0f, 0.0f, 0.0f};
    float s_fm[MAX_MINORS] = {0.0f, 0.0f, 0.0f};
    float s_minorfrac = 0.0f;
    auto minor_setup_i = [&](auto ic) {
        constexpr int i = decltype(ic)::value;
        if constexpr (i < NMINOR) {
            constexpr int W = i * MINOR_WORDS;      // word offset of minor i
            const int* M = D + W;
            const int im = I(I_INDMINOR);
            const int im1 = min(im + 1, 18);
            constexpr int ADJ_GAS = sw<BAND, REGION>(D_M0_ADJ_GAS + W);
            if constexpr (ADJ_GAS >= 0) {
                // over-abundance adjustment, chi_mls(gas, jp+1) reference
                const float colgas = F(ADJ_GAS);
                const float coldry = F(F_COLDRY);
                float chiref;
                if constexpr (sw<BAND, REGION>(D_M0_ADJ_CHI + W) >= 0)
                    chiref = T[M[D_M0_ADJ_CHI] + I(I_JP) + 1];
                else
                    chiref = bits(M[D_M0_ADJ_CHICONST]);
                const float ratio = 1.0e20f * colgas / (coldry * chiref);
                const float thresh = bits(M[D_M0_ADJ_THRESH]);
                const float base = bits(M[D_M0_ADJ_BASE]);
                const float expnt = bits(M[D_M0_ADJ_EXPNT]);
                const float excess = ratio > thresh ? ratio - base : 1.0f;
                const float adjfac = base + powf(excess, expnt);
                const float adjcol = adjfac * chiref * coldry * 1.0e-20f;
                colm[i] = ratio > thresh ? adjcol : colgas;
            } else {
                constexpr int COLA = sw<BAND, REGION>(D_M0_COLA + W);
                constexpr int COLB = sw<BAND, REGION>(D_M0_COLB + W);
                if constexpr (COLB >= 0)
                    colm[i] = F(COLA) * F(COLB);
                else
                    colm[i] = F(COLA);
            }
            const int moff = M[D_M0_OFF];
            if constexpr (sw<BAND, REGION>(D_M0_KIND + W) != 0) {  // eta
                const Eta e = eta_params(
                    F(sw<BAND, REGION>(D_M0_REF_G1 + W)),
                    F(sw<BAND, REGION>(D_M0_REF_G2 + W)),
                    bits(M[D_M0_REFRAT]), scale);
                const int nk = M[D_M0_NK];
                const int jm0 = rrtm::clampi(e.js, 0, nk - 2);
                fm[i] = e.fs;
                ma[i] = moff + (im * nk + jm0) * NG;
                mb[i] = moff + (im1 * nk + jm0) * NG;
            } else {
                ma[i] = moff + im * NG;
                mb[i] = moff + im1 * NG;
            }
        }
    };
    auto minor_setup = [&] {
        minorfrac = F(F_MINORFRAC);
        minor_setup_i(Int<0>{});
        minor_setup_i(Int<1>{});
        minor_setup_i(Int<2>{});
    };
    // every minor's rows first: s_minorfrac sums over (g, minor)
    auto minor_step = [&](int g, const float* u, float* tau) {
        float ml[MAX_MINORS][VW], mh[MAX_MINORS][VW];
        float ml1[MAX_MINORS][VW], mh1[MAX_MINORS][VW];
        auto rows = [&](auto ic) {
            constexpr int i = decltype(ic)::value;
            if constexpr (i < NMINOR) {
                load_row(T + ma[i] + g, ml[i]);
                load_row(T + mb[i] + g, mh[i]);
                if constexpr (sw<BAND, REGION>(D_M0_KIND + i * MINOR_WORDS)
                              != 0) {
                    load_row(T + ma[i] + NG + g, ml1[i]);
                    load_row(T + mb[i] + NG + g, mh1[i]);
                }
            }
        };
        rows(Int<0>{});
        rows(Int<1>{});
        rows(Int<2>{});
#pragma unroll
        for (int v = 0; v < VW; ++v) {
            auto term = [&](auto ic) {
                constexpr int i = decltype(ic)::value;
                if constexpr (i < NMINOR) {
                    float absm;
                    if constexpr (sw<BAND, REGION>(D_M0_KIND
                                                   + i * MINOR_WORDS) != 0) {
                        const float m00 = ml[i][v], m10 = ml1[i][v];
                        const float m01 = mh[i][v], m11 = mh1[i][v];
                        const float a1 = m00 + fm[i] * (m10 - m00);
                        const float a2 = m01 + fm[i] * (m11 - m01);
                        absm = a1 + minorfrac * (a2 - a1);
                        s_minorfrac += u[v] * colm[i] * (a2 - a1);
                        s_fm[i] += u[v] * colm[i]
                                   * ((1.0f - minorfrac) * (m10 - m00)
                                      + minorfrac * (m11 - m01));
                    } else {
                        const float lo = ml[i][v], hi = mh[i][v];
                        absm = lo + minorfrac * (hi - lo);
                        s_minorfrac += u[v] * colm[i] * (hi - lo);
                    }
                    tau[v] = tau[v] + colm[i] * absm;
                    s_colm[i] += u[v] * absm;
                }
            };
            term(Int<0>{});
            term(Int<1>{});
            term(Int<2>{});
        }
    };
    auto minor_back_i = [&](auto ic) {
        constexpr int i = decltype(ic)::value;
        if constexpr (i < NMINOR) {
            constexpr int W = i * MINOR_WORDS;
            const int* M = D + W;
            constexpr int ADJ_GAS = sw<BAND, REGION>(D_M0_ADJ_GAS + W);
            if constexpr (ADJ_GAS >= 0) {
                const float colgas = F(ADJ_GAS);
                const float coldry = F(F_COLDRY);
                float chiref;
                if constexpr (sw<BAND, REGION>(D_M0_ADJ_CHI + W) >= 0)
                    chiref = T[M[D_M0_ADJ_CHI] + I(I_JP) + 1];
                else
                    chiref = bits(M[D_M0_ADJ_CHICONST]);
                const float den = coldry * chiref;
                const float ratio = 1.0e20f * colgas / den;
                if (ratio > bits(M[D_M0_ADJ_THRESH])) {
                    const float base = bits(M[D_M0_ADJ_BASE]);
                    const float expnt = bits(M[D_M0_ADJ_EXPNT]);
                    const float excess = ratio - base;
                    const float adjfac = base + powf(excess, expnt);
                    // adjcol = adjfac * chiref * coldry * 1e-20
                    const float d_adjfac = s_colm[i] * 1.0e-20f * coldry
                                           * chiref;
                    const float d_ratio =
                        d_adjfac * expnt * powf(excess, expnt - 1.0f);
                    // ratio = 1e20 colgas / den, den = coldry chiref
                    acc.add(ADJ_GAS, d_ratio / den * 1.0e20f);
                    acc.add(F_COLDRY, s_colm[i] * 1.0e-20f * adjfac * chiref
                                      - d_ratio * (ratio / den) * chiref);
                } else {
                    acc.add(ADJ_GAS, s_colm[i]);
                }
            } else {
                constexpr int COLA = sw<BAND, REGION>(D_M0_COLA + W);
                constexpr int COLB = sw<BAND, REGION>(D_M0_COLB + W);
                if constexpr (COLB >= 0) {
                    acc.add(COLA, s_colm[i] * F(COLB));
                    acc.add(COLB, s_colm[i] * F(COLA));
                } else {
                    acc.add(COLA, s_colm[i]);
                }
            }
            if constexpr (sw<BAND, REGION>(D_M0_KIND + W) != 0) {
                constexpr int G1 = sw<BAND, REGION>(D_M0_REF_G1 + W);
                constexpr int G2 = sw<BAND, REGION>(D_M0_REF_G2 + W);
                eta_bwd(acc, G1, G2, -1, F(G1), F(G2), bits(M[D_M0_REFRAT]),
                        scale, 0.0f, s_fm[i]);
            }
        }
    };
    auto minor_back = [&] {
        acc.add(F_MINORFRAC, s_minorfrac);
        minor_back_i(Int<0>{});
        minor_back_i(Int<1>{});
        minor_back_i(Int<2>{});
    };

    // --- CFCs ----------------------------------------------------------
    float wx[MAX_CFCS] = {0.0f, 0.0f};
    int coff[MAX_CFCS] = {0, 0};
    float s_wx[MAX_CFCS] = {0.0f, 0.0f};
    auto cfc_setup = [&] {
        if constexpr (NCFC > 0) {
            wx[0] = F(sw<BAND, REGION>(D_C0_WX));
            coff[0] = D[D_C0_OFF];
        }
        if constexpr (NCFC > 1) {
            wx[1] = F(sw<BAND, REGION>(D_C1_WX));
            coff[1] = D[D_C1_OFF];
        }
    };
    auto cfc_step = [&](int g, const float* u, float* tau) {
#pragma unroll
        for (int c = 0; c < NCFC; ++c) {
            float x[VW];
            load_row(T + coff[c] + g, x);
#pragma unroll
            for (int v = 0; v < VW; ++v) {
                tau[v] = tau[v] + wx[c] * x[v];
                s_wx[c] += u[v] * x[v];
            }
        }
    };
    auto cfc_back = [&] {
#pragma unroll
        for (int c = 0; c < NCFC; ++c)
            acc.add(c == 0 ? sw<BAND, REGION>(D_C0_WX)
                           : sw<BAND, REGION>(D_C1_WX), s_wx[c]);
    };

    // --- the Planck fraction's eta row ---------------------------------
    int foff = 0;
    float s_fpl = 0.0f;
    auto frac_setup = [&] {
        const Eta e = eta_params(F(sw<BAND, REGION>(D_FRAC_G1)),
                                 F(sw<BAND, REGION>(D_FRAC_G2)),
                                 bits(D[D_FRAC_REFRAT]), scale);
        const int jpl0 = rrtm::clampi(e.js, 0, D[D_FRAC_NROW] - 2);
        foff = D[D_FRAC_OFF] + jpl0 * NG;
    };
    auto frac_step = [&](int g) {
        float x[VW], y[VW];
        load_row(T + foff + g, x);
        load_row(T + foff + NG + g, y);
#pragma unroll
        for (int v = 0; v < VW; ++v)
            s_fpl += ctf[(size_t)(g + v) * B] * (y[v] - x[v]);
    };
    auto frac_back = [&] {
        constexpr int G1 = sw<BAND, REGION>(D_FRAC_G1);
        constexpr int G2 = sw<BAND, REGION>(D_FRAC_G2);
        eta_bwd(acc, G1, G2, -1, F(G1), F(G2), bits(D[D_FRAC_REFRAT]), scale,
                0.0f, s_fpl);
    };

    if constexpr (CORR != 0) {
        // the pressure correction (bands 1-2): every term in one pass, as
        // s_corr sums ct x tau over all of them
        if constexpr (KEY1 >= 0) {
            key_row_setup(Int<0>{});
            key_row_setup(Int<1>{});
        }
        cont_setup();
        if constexpr (NMINOR > 0) minor_setup();
        cfc_setup();
        if constexpr (FRAC_ETA) frac_setup();
        float s_corr = 0.0f;
#pragma unroll 1
        for (int g = 0; g < NG; g += VW) {
            float ct[VW], u[VW], tau[VW] = {0.0f, 0.0f};
            cotangents(g, ct, u);
            if constexpr (KEY1 >= 0) {
                float acc0[VW], acc1[VW];
                key_row(Int<0>{}, g, u, acc0);
                key_row(Int<1>{}, g, u, acc1);
#pragma unroll
                for (int v = 0; v < VW; ++v)
                    tau[v] = speccomb * acc0[v] + speccomb1 * acc1[v];
            }
            cont_step(g, u, tau);
            if constexpr (NMINOR > 0) minor_step(g, u, tau);
            cfc_step(g, u, tau);
#pragma unroll
            for (int v = 0; v < VW; ++v) s_corr += ct[v] * tau[v];
            if constexpr (FRAC_ETA) frac_step(g);
        }
        if constexpr (KEY1 >= 0) key_back();
        cont_back();
        if constexpr (NMINOR > 0) minor_back();
        cfc_back();
        acc.add(F_PAVEL, s_corr * dcorr);
        if constexpr (FRAC_ETA) frac_back();
    } else {
        // one term at a time: its setup, its pass over g (the key species
        // one pressure row a pass), its chain-back; no sum reads tau
        float ct[VW], u[VW], tau[VW] = {0.0f, 0.0f}, acc_r[VW];
        if constexpr (KEY1 >= 0) {
            // the fraction's row rides on the first pass, whose loads wait
            // on device memory (the cotangents' first reads) anyway
            key_row_setup(Int<0>{});
            if constexpr (FRAC_ETA) frac_setup();
#pragma unroll 1
            for (int g = 0; g < NG; g += VW) {
                cotangents(g, ct, u);
                key_row(Int<0>{}, g, u, acc_r);
                if constexpr (FRAC_ETA) frac_step(g);
            }
            key_row_setup(Int<1>{});
#pragma unroll 1
            for (int g = 0; g < NG; g += VW) {
                cotangents(g, ct, u);
                key_row(Int<1>{}, g, u, acc_r);
            }
            key_back();
        }
        if constexpr (SELF || FOR) {
            cont_setup();
#pragma unroll 1
            for (int g = 0; g < NG; g += VW) {
                cotangents(g, ct, u);
                cont_step(g, u, tau);
            }
            cont_back();
        }
        if constexpr (NMINOR > 0) {
            minor_setup();
#pragma unroll 1
            for (int g = 0; g < NG; g += VW) {
                cotangents(g, ct, u);
                minor_step(g, u, tau);
            }
            minor_back();
        }
        if constexpr (NCFC > 0) {
            cfc_setup();
#pragma unroll 1
            for (int g = 0; g < NG; g += VW) {
                cotangents(g, ct, u);
                cfc_step(g, u, tau);
            }
            cfc_back();
        }
        if constexpr (FRAC_ETA) {
            if constexpr (KEY1 < 0) {
                frac_setup();
#pragma unroll 1
                for (int g = 0; g < NG; g += VW) frac_step(g);
            }
            frac_back();
        }
    }
    }
}

// Bands BAND..15 of one cell, each in its region's instantiation (a warp
// whose columns straddle laytrop runs both), in ascending order.
template <int BAND>
__device__ __forceinline__ void bands_from_bwd(bool lower, const int* desc,
                                               const float* fin,
                                               const short* iin,
                                               const float* T,
                                               const float* ctg,
                                               const float* ctf, size_t B,
                                               const Acc& acc) {
    constexpr int GOFF = sw<BAND, 0>(D_GOFF);
    static_assert(GOFF == sw<BAND, 1>(D_GOFF), "regions share g offsets");
    if (lower)
        cell_band_bwd<BAND, 0>(desc + (BAND * 2) * NDESC, fin, iin, T,
                               ctg + GOFF * B, ctf + GOFF * B, B, acc);
    else
        cell_band_bwd<BAND, 1>(desc + (BAND * 2 + 1) * NDESC, fin, iin, T,
                               ctg + GOFF * B, ctf + GOFF * B, B, acc);
    if constexpr (BAND + 1 < rrtm::NBAND)
        bands_from_bwd<BAND + 1>(lower, desc, fin, iin, T, ctg, ctf, B,
                                 acc);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
taumol_bwd_kernel(const float* __restrict__ fld, const int* __restrict__ ifld,
                  const float* __restrict__ T, const int* __restrict__ desc,
                  const float* __restrict__ ct_taug,
                  const float* __restrict__ ct_fracs,
                  float* __restrict__ ct_fld, int L, int B) {
    __shared__ float sfld[NF * TB];            // (NF, TB) inputs
    __shared__ float sacc[NF * TB];            // (NF, TB) field sums
    __shared__ short sifld[NI * TB];           // (NI, TB) int inputs
    const int c = threadIdx.x;
    const int b0 = blockIdx.x * TB;
    const int l = blockIdx.y;
    const int nb = min(TB, B - b0);            // columns of this tile
    const size_t LB = (size_t)L * B;
    const size_t cell0 = (size_t)l * B + b0;

    for (int i = c; i < (NF + NI) * TB; i += THREADS) {
        const int f = i / TB, k = i % TB;
        if (k >= nb) continue;
        if (f < NF) sfld[i] = fld[f * LB + cell0 + k];
        else sifld[i - NF * TB] = (short)ifld[(f - NF) * LB + cell0 + k];
    }
    for (int f = 0; f < NF; ++f) sacc[f * TB + c] = 0.0f;
    __syncthreads();
    if (c >= nb) return;

    const size_t off = (size_t)l * rrtm::NGPT * B + b0 + c;
    bands_from_bwd<0>(sifld[I_LAYTROP * TB + c] != 0, desc, sfld + c,
                      sifld + c, T, ct_taug + off, ct_fracs + off, (size_t)B,
                      Acc{sacc + c});
    for (int f = 0; f < NF; ++f)
        ct_fld[f * LB + cell0 + c] = sacc[f * TB + c];
}

}  // namespace

// fld (NF, L, B) f32, ifld (NI, L, B) i32, tabs, desc as rrtm_taumol
// (desc's BAND_SPECS words the compiled Shape's; every table starting
// on TAB_ALIGN floats); ct_taug, ct_fracs (L, 140, B) -> ct_fld
// (NF, L, B).
RRTM_API int rrtm_taumol_bwd(const float* fld, const int* ifld,
                             const float* tabs, const int* desc,
                             const float* ct_taug, const float* ct_fracs,
                             float* ct_fld, int L, int B, void* stream) {
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    if (reinterpret_cast<uintptr_t>(tabs) % (TAB_ALIGN * 4) != 0)
        return (int)cudaErrorMisalignedAddress;
    const dim3 grid((B + TB - 1) / TB, L);
    taumol_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        fld, ifld, tabs, desc, ct_taug, ct_fracs, ct_fld, L, B);
    return (int)cudaGetLastError();
}

// K5's launch configuration: out[0..6] as rrtm_taumol_info (registers
// per thread, local memory bytes per thread, static and dynamic shared
// memory bytes per block, blocks per SM, threads per block, columns per
// block)
RRTM_API int rrtm_taumol_bwd_info(int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, taumol_bwd_kernel);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, taumol_bwd_kernel, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = 0;
    out[4] = blocks;
    out[5] = THREADS;
    out[6] = TB;
    return (int)cudaSuccess;
}
