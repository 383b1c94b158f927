// K1 (rtrn_kernel.cuh) in the gradient step, keeping the state K6 reads:
// 6 modes x idrv 0/1 x the two store paths (SAVE_BULK, SAVE_SCALAR), in
// float32, in a translation unit of their own.
#include "rtrn_kernel.cuh"

namespace {

// the store path of each mode's last launch (NO_SAVE: none yet)
int g_save_path[6] = {};

// K1 in MODE keeping the state: bulk tensor stores where tensor maps can
// address taut, fracs and rads (rows of B floats 16-byte aligned), else
// scalar stores; a map that does not encode raises (no fallback)
template <int MODE>
cudaError_t launch_kept(const Inputs& in, const int* ngb, const float* wg,
                        float* out, int idrv, const Kept& kp,
                        cudaStream_t s) {
    constexpr int F32 = rrtm::SPEC_F32;
    KeptArgs ka{};
    ka.words = kp.words;
    const int B = in.B;
    const bool bulk = map_rows_ok(in.taut, B) && map_rows_ok(in.fracs, B)
                      && map_rows_ok(kp.rads, B);
    if (bulk) {
        const uint64_t lg = (uint64_t)in.L * KG;
        // and the d/dT derivatives where they are kept (staged: PBULK)
        const uint64_t planes =
            MODE == CLEAR ? 2 : idrv && keeps_ddt(MODE) ? 6 : 4;
        // a box row is 64 bytes: the L2 fetches the whole 128-byte line,
        // whose other half the neighbouring block reads
        if (!tensor_map_rows(&ka.taut, in.taut, lg, B, KX, KG,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B)
            || !tensor_map_rows(&ka.fracs, in.fracs, lg, B, KX, KG,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_128B)
            || !tensor_map_rows(&ka.rads, kp.rads, planes * lg, B, KX, KG,
                                CU_TENSOR_MAP_L2_PROMOTION_NONE))
            return cudaErrorInvalidValue;
    }
    g_save_path[MODE] = bulk ? SAVE_BULK : SAVE_SCALAR;
    if (bulk)
        return idrv ? launch<MODE, true, F32, SAVE_BULK>(in, ngb, wg, out, kp,
                                                         ka, s)
                    : launch<MODE, false, F32, SAVE_BULK>(in, ngb, wg, out,
                                                          kp, ka, s);
    return idrv ? launch<MODE, true, F32, SAVE_SCALAR>(in, ngb, wg, out, kp,
                                                       ka, s)
                : launch<MODE, false, F32, SAVE_SCALAR>(in, ngb, wg, out, kp,
                                                        ka, s);
}

template <int MODE>
cudaError_t info_kept(int idrv, int path, int* out) {
    constexpr int F32 = rrtm::SPEC_F32;
    if (path == SAVE_BULK)
        return idrv ? info<MODE, true, F32, SAVE_BULK>(out)
                    : info<MODE, false, F32, SAVE_BULK>(out);
    if (path == SAVE_SCALAR)
        return idrv ? info<MODE, true, F32, SAVE_SCALAR>(out)
                    : info<MODE, false, F32, SAVE_SCALAR>(out);
    return cudaErrorInvalidValue;
}

}  // namespace

// the mode's cloud inputs, and (maxrand) a packed state of at least one
// slot, (fused, cldf-odcld, compact at idrv=1) the words, must be given
cudaError_t rrtm::rt::launch_save(const Inputs& in, const int* ngb,
                                  const float* wg, float* out, int mode,
                                  int idrv, const Kept& kp, cudaStream_t s) {
    if (!kp.rads || !clouds_given(in, mode)
        || (mode == MAXRAND && (!kp.packed || kp.npk < 1))
        || ((mode == FUSED || mode == CLDF_OD || (mode == COMPACT && idrv))
            && !kp.words))
        return cudaErrorInvalidValue;
    switch (mode) {
    case CLEAR: return launch_kept<CLEAR>(in, ngb, wg, out, idrv, kp, s);
    case COMPACT: return launch_kept<COMPACT>(in, ngb, wg, out, idrv, kp, s);
    case BANDED: return launch_kept<BANDED>(in, ngb, wg, out, idrv, kp, s);
    case MAXRAND: return launch_kept<MAXRAND>(in, ngb, wg, out, idrv, kp, s);
    case FUSED: return launch_kept<FUSED>(in, ngb, wg, out, idrv, kp, s);
    case CLDF_OD: return launch_kept<CLDF_OD>(in, ngb, wg, out, idrv, kp, s);
    default: return cudaErrorInvalidValue;
    }
}

cudaError_t rrtm::rt::info_save(int mode, int idrv, int path, int* out) {
    switch (mode) {
    case CLEAR: return info_kept<CLEAR>(idrv, path, out);
    case COMPACT: return info_kept<COMPACT>(idrv, path, out);
    case BANDED: return info_kept<BANDED>(idrv, path, out);
    case MAXRAND: return info_kept<MAXRAND>(idrv, path, out);
    case FUSED: return info_kept<FUSED>(idrv, path, out);
    case CLDF_OD: return info_kept<CLDF_OD>(idrv, path, out);
    default: return cudaErrorInvalidValue;
    }
}

int rrtm::rt::save_path(int mode) {
    return mode >= 0 && mode < 6 ? g_save_path[mode] : NO_SAVE;
}
