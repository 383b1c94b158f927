// K7: the reduced spectral storage of taug / fracs between K2 and K1
// (RRTMG_SPEC_DTYPE), as device functions: K2 stores through
// spec_store_*, K1 reads through spec_load_*.
//
// Replaces the codec of rrtmg_lw_tpu/ops/taumol_pallas.py:288-338, used
// by the Pallas taumol kernel's store (_enc / write_out, :866-884) and
// the Pallas RT kernel's reads (rtrn_pallas.py:234, :259-261, :499).
// The plain versions are ops/spec_codec.py; every float operation here
// follows them one for one (the library builds with -fmad=false, so no
// multiply-add is contracted), with the JAX package's constants rounded
// to float32 exactly as its weakly typed Python floats are.
//
// Storage in 16 bits halves the bytes of the taug / fracs round trip,
// the largest HBM term of the forward step; the cost is one logf per
// element in K2 and one expf per read in K1 (logu16), or a conversion
// (bf16, f16).  K1 in reduced storage adds the aerosol od itself, after
// the decode (rtrn_pallas.py:263-275): the sum cannot be stored as codes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace rrtm {

// the storage argument of rrtm_taumol / rrtm_rt (spec_codec.SPEC_CODES)
enum Spec { SPEC_F32 = 0, SPEC_BF16 = 1, SPEC_F16 = 2, SPEC_LOGU16 = 3 };

template <int SPEC> struct SpecType;
template <> struct SpecType<SPEC_F32> { using T = float; };
template <> struct SpecType<SPEC_BF16> { using T = __nv_bfloat16; };
template <> struct SpecType<SPEC_F16> { using T = __half; };
template <> struct SpecType<SPEC_LOGU16> { using T = uint16_t; };

// float32 values of log(1e-9), 65534 / (log 4 - log 1e-9), its inverse
// (taken in double, then rounded), 1 / 65535 and 1e-9
constexpr float SPEC_LOG_LO = -0x1.4b928p+4f;
constexpr float SPEC_LOG_SCALE = 0x1.7281d4p+11f;
constexpr float SPEC_INV_SCALE = 0x1.61c386p-12f;
constexpr float SPEC_INV_FRAC = 0x1.0001p-16f;
constexpr float SPEC_FLOOR = 0x1.12e0bep-30f;

// spec_codec.spec_encode_taug
__device__ __forceinline__ uint16_t encode_taug(float x) {
    const float e = logf(fmaxf(x, SPEC_FLOOR));
    float u = rintf((e - SPEC_LOG_LO) * SPEC_LOG_SCALE);
    u = fminf(fmaxf(u, 0.0f), 65534.0f) + 1.0f;
    return x > SPEC_FLOOR ? (uint16_t)(int)u : (uint16_t)0;
}

// spec_codec.spec_encode_frac
__device__ __forceinline__ uint16_t encode_frac(float f) {
    return (uint16_t)(int)rintf(fminf(fmaxf(f, 0.0f), 1.0f) * 65535.0f);
}

// spec_codec.spec_decode_taug
__device__ __forceinline__ float decode_taug(uint16_t u) {
    const float uf = (float)u;
    const float v = expf(SPEC_LOG_LO + uf * SPEC_INV_SCALE - SPEC_INV_SCALE);
    return u == 0 ? 0.0f : v;
}

// the store of K2: taug (TAUG) or fracs as storage SPEC
template <int SPEC, bool TAUG>
__device__ __forceinline__ typename SpecType<SPEC>::T spec_enc(float x) {
    if constexpr (SPEC == SPEC_F32) return x;
    else if constexpr (SPEC == SPEC_BF16) return __float2bfloat16_rn(x);
    else if constexpr (SPEC == SPEC_F16) return __float2half_rn(x);
    else return TAUG ? encode_taug(x) : encode_frac(x);
}

// the reads of K1: taug (TAUG) or fracs from storage SPEC, as float32
template <int SPEC, bool TAUG>
__device__ __forceinline__ float spec_load(const float* base, size_t i) {
    if constexpr (SPEC == SPEC_F32) {
        return base[i];
    } else {
        using T = typename SpecType<SPEC>::T;
        const T v = reinterpret_cast<const T*>(base)[i];
        if constexpr (SPEC == SPEC_BF16) return __bfloat162float(v);
        else if constexpr (SPEC == SPEC_F16) return __half2float(v);
        else return TAUG ? decode_taug(v) : (float)v * SPEC_INV_FRAC;
    }
}

}  // namespace rrtm
