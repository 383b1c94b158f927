// K1, the RT sweep kernel (rtrn_kernel.cuh): its float32 instantiations
// of the forward step (6 modes x idrv 0/1) and the entry points, which
// dispatch the reduced storages to rtrn_bf16.cu, rtrn_f16.cu and
// rtrn_logu16.cu and the gradient step's launches, which keep the
// radiances for K6, to rtrn_save.cu.
#include "rtrn_kernel.cuh"

// taut, fracs (L, 140, B) in storage `spec` (spec.cuh; float32: taut =
// taug + the aerosol od); taua (L, 16, B) the aerosol od, read in reduced
// storage only (null in float32); play (L, 16, B); plev (L+1, 16, B); surf
// (3, 16, B) = secdiff, semiss, plankbnd, and with idrv = 1 (4, 16, B)
// with dplankbnd_dt as row 3; ngb (140,) 0-based band of each g; wg
// (140,) flux weights; mode (enum Mode):
//   COMPACT: mask (L, 144, B) int8, cw (L, 2, B), abi, abl (L, 16, B);
//   BANDED:  cld = cldfrac (L, B), taucb (L, 16, B) cloud od per band;
//   MAXRAND: cld = overlap rows (L, 16, B), taucb as BANDED;
//   FUSED:   cldf, ciwp, clwp, tauc (L, 144, B), abi, abl (L, 16, B);
//   CLDF_OD: cldf, tauc = cldprmc's cloud od (L, 144, B);
// the other cloud pointers may be null.
// -> out (4, L+1, B) = up, down, clear up, clear down; idrv = 1:
// (6, L+1, B), + d up / dT_sfc, d clear up / dT_sfc.  rads null: K1 as
// the forward step runs it; else (float32, the gradient step) it also
// writes the per-g radiances to rads (2 | 4, L, 140, B): the down
// radiance at level l, the up radiance entering layer l and, in a cloudy
// mode, their clear twins; maxrand also the sub-streams entering each
// layer where K6 reads them, packed into npk slots a sweep, packed (2,
// 3, npk, 140, B); fused and cldf-odcld (and compact at idrv = 1) also
// the cloudy-layer words, words ((B + 31) / 32, L) uint32 (rtrn_kernel.cuh,
// SAVE; null elsewhere); at idrv = 1 banded, maxrand, fused, cldf-odcld
// and compact also the d/dT derivatives entering each layer and their
// clear twins: rads (6, L, 140, B) there.
RRTM_API int rrtm_rt(const void* taut, const void* fracs, const float* play,
                     const float* plev, const float* surf, const int* ngb,
                     const float* wg, const int8_t* mask, const float* cw,
                     const float* abi, const float* abl, const float* cld,
                     const float* taucb, const float* cldf, const float* ciwp,
                     const float* clwp, const float* tauc, const float* taua,
                     float* out, int L, int B, int mode, int idrv, int spec,
                     float* rads, float* packed, int npk, unsigned* words,
                     void* stream) {
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    if (rads && spec != rrtm::SPEC_F32) return (int)cudaErrorInvalidValue;
    Inputs in{static_cast<const float*>(taut),
              static_cast<const float*>(fracs), play, plev, surf, mask, cw,
              abi, abl, L, B};
    in.cld = cld;
    in.taucb = taucb;
    in.cldf = cldf;
    in.ciwp = ciwp;
    in.clwp = clwp;
    in.tauc = tauc;
    cudaStream_t s = (cudaStream_t)stream;
    if (rads)
        return (int)launch_save(
            in, ngb, wg, out, mode, idrv,
            Kept{rads, packed, npk, reinterpret_cast<uint16_t*>(words)}, s);
    switch (spec) {
    case rrtm::SPEC_F32:
        return (int)launch_storage<rrtm::SPEC_F32>(in, taua, ngb, wg, out,
                                                   mode, idrv, s);
    case rrtm::SPEC_BF16:
        return (int)launch_bf16(in, taua, ngb, wg, out, mode, idrv, s);
    case rrtm::SPEC_F16:
        return (int)launch_f16(in, taua, ngb, wg, out, mode, idrv, s);
    case rrtm::SPEC_LOGU16:
        return (int)launch_logu16(in, taua, ngb, wg, out, mode, idrv, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// The launch configuration of K1 in `mode` at idrv in storage `spec`
// (save: the instantiation that keeps the radiances, SAVE_SCALAR or
// SAVE_BULK, float32; NO_SAVE the forward step's): out[0..7] = registers
// per thread, local memory bytes per thread, static and dynamic shared
// memory per block, blocks per SM, the ring's levels, threads and columns
// per block (rtrn_kernel.cuh info).
RRTM_API int rrtm_rt_info(int mode, int idrv, int spec, int save, int* out) {
    if (save != NO_SAVE) {
        if (spec != rrtm::SPEC_F32) return (int)cudaErrorInvalidValue;
        return (int)info_save(mode, idrv, save, out);
    }
    switch (spec) {
    case rrtm::SPEC_F32:
        return (int)info_storage<rrtm::SPEC_F32>(mode, idrv, out);
    case rrtm::SPEC_BF16: return (int)info_bf16(mode, idrv, out);
    case rrtm::SPEC_F16: return (int)info_f16(mode, idrv, out);
    case rrtm::SPEC_LOGU16: return (int)info_logu16(mode, idrv, out);
    default: return (int)cudaErrorInvalidValue;
    }
}

// The store path of `mode`'s last launch that kept the radiances in this
// process: SAVE_BULK, SAVE_SCALAR, or NO_SAVE where there was none.
RRTM_API int rrtm_rt_save_path(int mode) { return save_path(mode); }
