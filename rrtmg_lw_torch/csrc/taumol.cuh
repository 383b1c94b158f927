// Shared by K2 (taumol.cu) and K5 (taumol_bwd.cu): the layout of the
// packed per-cell inputs and of the (band, region) descriptor that
// ops/taumol_cuda.py::pack_tables writes, and the eta interpolation of
// ops/taumol.py (_eta_params, _spec_weights).
#pragma once

#include "rrtm.cuh"

namespace rrtm {
namespace taumol {

// Order must match FLOAT_FIELDS / INT_FIELDS / DESC_FIELDS in
// ops/taumol_cuda.py.
enum FloatField {
    F_COLH2O, F_COLCO2, F_COLO3, F_COLN2O, F_COLCO, F_COLCH4, F_COLO2,
    F_COLBRD, F_FAC00, F_FAC01, F_FAC10, F_FAC11, F_RAT_H2OCO2,
    F_RAT_H2OCO2_1, F_RAT_H2OO3, F_RAT_H2OO3_1, F_RAT_H2ON2O,
    F_RAT_H2ON2O_1, F_RAT_H2OCH4, F_RAT_H2OCH4_1, F_RAT_N2OCO2,
    F_RAT_N2OCO2_1, F_RAT_O3CO2, F_RAT_O3CO2_1, F_SELFFAC, F_SELFFRAC,
    F_FORFAC, F_FORFRAC, F_MINORFRAC, F_SCALEMINOR, F_SCALEMINORN2,
    F_COLDRY, F_WX0, F_WX1, F_WX2, F_WX3, F_PAVEL, NF
};
enum IntField {
    I_LAYTROP, I_JP, I_JT, I_JT1, I_INDSELF, I_INDFOR, I_INDMINOR, NI
};
enum Desc {
    D_ZERO, D_GOFF, D_NGB, D_KEY1, D_KEY2, D_RAT0, D_RAT1, D_NSP, D_ETA4,
    D_ABS_OFF, D_NROW, D_NA, D_SELF_OFF, D_FOR_OFF, D_NMINOR, D_M0_KIND,
    D_M0_OFF, D_M0_NK, D_M0_COLA, D_M0_COLB, D_M0_ADJ_GAS, D_M0_ADJ_CHI,
    D_M0_ADJ_THRESH, D_M0_ADJ_BASE, D_M0_ADJ_EXPNT, D_M0_ADJ_CHICONST,
    D_M0_REF_G1, D_M0_REF_G2, D_M0_REFRAT, D_M1_KIND, D_M1_OFF, D_M1_NK,
    D_M1_COLA, D_M1_COLB, D_M1_ADJ_GAS, D_M1_ADJ_CHI, D_M1_ADJ_THRESH,
    D_M1_ADJ_BASE, D_M1_ADJ_EXPNT, D_M1_ADJ_CHICONST, D_M1_REF_G1,
    D_M1_REF_G2, D_M1_REFRAT, D_M2_KIND, D_M2_OFF, D_M2_NK, D_M2_COLA,
    D_M2_COLB, D_M2_ADJ_GAS, D_M2_ADJ_CHI, D_M2_ADJ_THRESH, D_M2_ADJ_BASE,
    D_M2_ADJ_EXPNT, D_M2_ADJ_CHICONST, D_M2_REF_G1, D_M2_REF_G2,
    D_M2_REFRAT, D_NCFC, D_C0_WX, D_C0_OFF, D_C1_WX, D_C1_OFF, D_CORR,
    D_POST_OFF, D_FRAC_OFF, D_FRAC_ETA, D_FRAC_NROW, D_FRAC_G1, D_FRAC_G2,
    D_FRAC_REFRAT, NDESC
};
constexpr int MAX_MINORS = 3;
constexpr int MINOR_WORDS = D_M1_KIND - D_M0_KIND;
constexpr int MAX_CFCS = 2;
static_assert(D_NCFC == D_M0_KIND + MAX_MINORS * MINOR_WORDS, "desc");
static_assert(D_CORR == D_C0_WX + 2 * MAX_CFCS, "desc");

// constants.ONEMINUS, rounded as torch rounds the clamp bound
constexpr float ONEMINUS_F = (float)(1.0 - 1.0e-6);

__device__ __forceinline__ float bits(int w) { return __int_as_float(w); }

struct Eta {
    float speccomb, specparm, fs;
    int js;
};

// taumol._eta_params: speccomb, specparm, js (trunc), fs.
__device__ __forceinline__ Eta eta_params(float c1, float c2, float rat,
                                          float scale) {
    Eta e;
    e.speccomb = c1 + rat * c2;
    e.specparm = fminf(c1 / e.speccomb, ONEMINUS_F);
    const float specmult = scale * e.specparm;
    e.js = (int)specmult;
    e.fs = specmult - (float)e.js;
    return e;
}

// taumol._spec_weights: taps at offsets -1, 0, +1, +2.
__device__ __forceinline__ void spec_weights(float specparm, float fs,
                                             float* w) {
    const bool low = specparm < 0.125f;
    const bool high = specparm > 0.875f;
    const float p = low ? fs - 1.0f : -fs;
    const float p2 = p * p;
    const float p4 = p2 * p2;
    const float fk0 = p4;
    const float fk1 = 1.0f - p - 2.0f * p4;
    const float fk2 = p + p4;
    w[0] = high ? fk2 : 0.0f;
    w[1] = low ? fk0 : (high ? fk1 : 1.0f - fs);
    w[2] = low ? fk1 : (high ? fk0 : fs);
    w[3] = low ? fk2 : 0.0f;
}

}  // namespace taumol
}  // namespace rrtm
