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
// What bounds it on the H100.  Each sweep reads taut and fracs (L, 140,
// B) once, ~1.1 GB per sweep at B=16384, L=60 in float32 (the up sweep
// RECOMPUTES its per-level factors from them: a cache of the 6 factors
// would write and re-read ~3.3 GB), with the Planck rows and the cloud
// inputs ~1.3 GB, ~0.39 ms at 3.35 TB/s; against that ~30 flops, an expf
// and two IEEE divisions per (level, g, column) and sweep (~1 ms of issue
// on 132 SMs).  Read once per sweep, the bytes are ~0.75 ms: the kernel
// is held by both, and by the latency of the level recurrence between
// them.
//
// Design.  A block holds 16 columns x 16 g-lanes (256 threads, two blocks
// per SM at <= 128 registers); each thread carries the radiances of 9 of
// the 140 g-points of its column in registers (maxrand: 5 floats per g;
// idrv adds 2 per g in the up sweep).
// - Staged levels: every input row of a level (taut, fracs, the Planck
//   rows of the 16 bands, the aerosol od in reduced storage, the mask,
//   cloud fraction or overlap rows, the ice and liquid coefficients
//   (fused) or per-band cloud od) is copied into a ring of RING levels
//   in shared memory by cp.async, RING - 1 levels ahead of the one the
//   sweep is on, 16 bytes a copy where the rows are 16-byte aligned and
//   the tile is full (element by element otherwise: B not a multiple of
//   4, 8 or 16 for 4-, 2- or 1-byte elements, or the ragged last tile).
//   Each slot has an mbarrier on which every thread's copies arrive
//   (cp.async.mbarrier.arrive.noinc); a thread waits on the slot of the
//   level it reads, not on the block.  16-bit codes are decoded once per
//   staged element, where the sweep reads them.
// - One block barrier per level: it frees the ring slot of the previous
//   level, publishes
//   the g-lanes' partial fluxes of the previous level, which lanes 0-1
//   (0-3 at idrv=1) then sum in a fixed order (deterministic, no atomics),
//   and publishes the per-g modes' cloudy-layer flags of the next level.
// - Cloudy-layer flags: a layer is cloudy for a column when any of its
//   g-points has a cloud fraction >= 0.5 (compact, fused, cldf-odcld) or
//   where its cloud fraction is >= 1e-6 (banded, maxrand).  In the per-g
//   modes each warp ballots its g-points of level i+1 from the staged
//   slot while the sweep is at level i; the ballots are OR-ed at level
//   i+1.  The clear twin stream of every g follows the cloudy stream until
//   the first cloudy layer above (iclddn, down sweep) or anywhere in the
//   column (up sweep); maxrand reads iclddn, the sub-stream restart flags
//   and the overlap factors from the rows the overlap kernel (overlap.cu)
//   made.
// - Cloud terms only where a g-point is cloudy (compact, fused,
//   cldf-odcld): where the g's gate (cf >= 0.5) is false the cloud od is
//   0 and the total-sky factors are the gas factors; they are taken from
//   gas_factors except at od == 0.06 exactly, where the gas (od <= 0.06)
//   and total (od < 0.06) branches differ and tot_factors runs as in the
//   spec.  No cloud expf and no second pair of divisions runs outside the
//   cloudy elements (under 5% of them in the McICA cells).  The per-g
//   water paths and cloud od (fused, cldf-odcld) and compact's ice and
//   liquid coefficients are read from device memory only there.
// - Levels where no column of the tile is cloudy (a block-uniform
//   branch) run the gas factors alone: the recurrences read nothing
//   else there, so the results are bitwise those of the full step.
//
// Storage (RRTMG_SPEC_DTYPE): a third template parameter, SPEC
// (spec.cuh), stages taut and fracs in float32 (taua already added by the
// model) or as bf16, f16 or logu16 codes (rtrn_pallas.py:234, :259-261,
// :499), with the aerosol od of the band added to the decoded taug
// inside the kernel (:263-275).  rtrn.cu instantiates the float32 kernels
// and holds the entry points; rtrn_bf16.cu, rtrn_f16.cu and
// rtrn_logu16.cu the reduced ones, one translation unit each so that nvcc
// builds them in parallel.
//
// The gradient step (SAVE, a fourth template parameter: every mode in
// float32, idrv 0 and 1): the kernel also stores every
// per-g radiance that it sums into the flux rows DOWN, UP (and CLR_DOWN,
// CLR_UP) at levels 0..L-1, in the order K6
// (rtrn_bwd.cu; maxrand: rtrn_bwd_mr.cu; banded, fused and cldf-odcld:
// rtrn_bwd_g.cu) reads them back: (2 | 4, L, 140, B) floats, 1.1 GB clear
// and 2.2 GB in a cloudy mode at B=16384, L=60; maxrand
// also the three sub-streams entering a layer in a sweep where K6 reads
// them, in a cloudy layer that does not restart them, packed: (2, 3, K,
// 140, B), a column's k-th such layer of a sweep at slot k, K the most
// of any column (3 at the cells' clouds, 0.2 GB); fused and cldf-odcld
// (and compact at idrv=1, whose d/dT adjoint runs on K6-g's tile) also
// the cloudy-layer words K6 reads in those modes (a bit per column,
// one uint32 per 32-column tile and layer: the block of columns 16u ..
// 16u + 15 writes half u % 2 of its tile's word, the last block of an
// odd count the whole word); at idrv=1 in the banded, maxrand, fused,
// cldf-odcld and compact modes (keeps_ddt) also the d/dT derivative
// entering each layer and its clear twin, P and PC (rads (6, L, 140, B),
// planes 4-5; level l, the seed fracs[0] x dplankbnd_dt at l = 0), which
// their d/dT K6 reads in its reverse up sweep in place of a scratch of
// its own (rtrn_bwd_g.cu, rtrn_bwd_mr.cu), 1.1 GB more at B=16384, L=60:
// by scalar stores from the registers in both store paths, a warp's store
// 16 columns x 2 g-points (the slot has no spare per-g tiles for them);
// in SAVE_BULK where two blocks per SM still fit two more tiles (banded,
// cldf-odcld; not maxrand, whose ring of three and sub-streams fill it),
// staged in shared memory and written by bulk tensor stores with the
// step's radiances (one buffer: each thread waits for the previous step's
// tiles to be read before it writes its cells), cheaper there than the
// scalar stores on the H100.  The stores change nothing in the flux
// sums: the fluxes are bitwise those of the kernel without SAVE.
// - SAVE_BULK, where tensor maps can address rads, taut and fracs (B a
//   multiple of 4, the bases 16-byte aligned): a step's radiances leave
//   the registers through its own ring slot.  A thread writes each of
//   its g-points' radiance over the slot's TAU cell and the clear twin
//   over its FR cell, which it alone has read, in the step; after the
//   step's block barrier one elected thread writes the two tiles out by
//   bulk tensor stores (a box of 16 columns x 140 rows each; the TMA
//   clips the ragged last tile), which run behind the next steps.  The
//   same thread stages the slot's taut and fracs rows by bulk tensor
//   loads once its stores have read the tiles (the other rows keep their
//   cp.async copies; the slot's mbarrier counts both), so the ring's
//   lead stays RING - 1 levels.  No shared memory is added but 128 bytes
//   to align the ring (a slot's stride rounded to 128 bytes).
// - SAVE_SCALAR elsewhere: scalar stores from the registers inside the
//   g-loop, a warp's store 16 columns x 2 g-points (two 64-byte pieces).
// The host chooses the path from the shapes before the launch.  K6
// shares with this file only the recurrences (advance, advance_ddt,
// advance_mr) and the factor functions of rtrn.cuh.
#pragma once

#include <stdint.h>

#include <type_traits>

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
// the launch configuration of one instantiation (rrtm_rt_info)
cudaError_t info_bf16(int mode, int idrv, int* out);
cudaError_t info_f16(int mode, int idrv, int* out);
cudaError_t info_logu16(int mode, int idrv, int* out);

// K1's launch in the gradient step (the fourth template parameter): none
// (the forward step), scalar stores from the registers, or bulk tensor
// stores from the ring slot
enum Save { NO_SAVE = 0, SAVE_SCALAR = 1, SAVE_BULK = 2 };

// the state K1 keeps in the gradient step: the radiances, maxrand's
// packed sub-streams and their slots a sweep, the per-g modes'
// cloudy-layer words (uint16 halves of the uint32 words)
struct Kept {
    float* rads = nullptr;
    float* packed = nullptr;
    int npk = 0;
    uint16_t* words = nullptr;
};

// K1 in float32 keeping the state (rtrn_save.cu): the store path chosen
// from the shapes; its launch configuration (path SAVE_SCALAR or
// SAVE_BULK); the path of `mode`'s last launch (NO_SAVE: none yet)
cudaError_t launch_save(const Inputs& in, const int* ngb, const float* wg,
                        float* out, int mode, int idrv, const Kept& kp,
                        cudaStream_t s);
cudaError_t info_save(int mode, int idrv, int path, int* out);
int save_path(int mode);

}  // namespace rt
}  // namespace rrtm

namespace {

using namespace rrtm::rt;

// Byte layout of one level in the ring: the (g or band or row, column)
// tiles of the level's inputs, KX columns each.
template <int MODE, int SPEC>
struct Slot {
    static constexpr int ES = sizeof(typename rrtm::SpecType<SPEC>::T);
    static constexpr int BAND_ROW = KX * 4;
    static constexpr int TAU = 0;
    static constexpr int FR = align16(TAU + KG * KX * ES);
    static constexpr int PLAY = align16(FR + KG * KX * ES);
    static constexpr int PLEV = PLAY + KNB * BAND_ROW;
    static constexpr int TAUA = PLEV + KNB * BAND_ROW;
    // the band rows of the cloud optics: fused: abi, abl (16, KX) each;
    // banded, maxrand: taucb (16, KX).  Not in compact: its ~6 cloudy
    // levels of 60 read abi, abl from device memory, cheaper than copying
    // them at every level (measured on the H100: 1.73 against 1.71 ms,
    // 4.00 against 3.75 at L=140)
    static constexpr int BC =
        TAUA + (SPEC != rrtm::SPEC_F32 ? KNB * BAND_ROW : 0);
    static constexpr int NBC = MODE == FUSED ? 2 * KNB
                               : (MODE == BANDED || MODE == MAXRAND) ? KNB
                               : 0;
    // compact: int8 mask (KG, KX), then cw (2, KX); fused, cldf-odcld:
    // cldf (KG, KX); banded: cldfrac (KX); maxrand: rows (NROW, KX)
    static constexpr int CLD = BC + NBC * BAND_ROW;
    static constexpr int CW = align16(CLD + KG * KX);
    static constexpr int END =
        MODE == COMPACT ? CW + 2 * BAND_ROW
        : (MODE == FUSED || MODE == CLDF_OD) ? CLD + KG * BAND_ROW
        : MODE == BANDED ? CLD + BAND_ROW
        : MODE == MAXRAND ? CLD + NROW * BAND_ROW : CLD;
    static constexpr int BYTES = align16(END);
};

// The block's dynamic shared memory: the ring, one mbarrier per slot,
// two buffers of the g-lanes' partial fluxes (NUP rows), two of the
// warps' cloud ballots, the band and weight of every g, the columns'
// diffusivity secants per band, and in maxrand the sub-stream carries.
// What a thread would otherwise hold through the sweep in registers
// (bands, secants, sub-streams) lives here: at 128 registers a thread
// (two blocks per SM) the radiances and the step's temporaries fill
// them.
// BULK (SAVE_BULK): the ring starts at a 128-byte boundary (128 bytes
// more to align it) and a slot's stride is rounded to 128 bytes, so that
// its TAU and FR tiles can be bulk copies' boxes.
template <int MODE, bool IDRV, int SPEC, bool BULK = false>
struct Layout {
    using S = Slot<MODE, SPEC>;
    static constexpr int SLOT = BULK ? (S::BYTES + 127) / 128 * 128
                                     : S::BYTES;
    static_assert(!BULK || (S::TAU % 128 == 0 && S::FR % 128 == 0),
                  "the TAU and FR tiles at 128-byte boundaries");
    static constexpr int NUP = IDRV ? 4 : 2;
    // maxrand: the cloudy, clear and correction sub-streams of every g,
    // and (SAVE) each thread's count of its column's kept layers
    static constexpr int SUB_BYTES = MODE == MAXRAND ? 3 * KGPT * KT * 4 : 0;
    static constexpr int CNT_BYTES = MODE == MAXRAND ? KT * 4 : 0;
    static constexpr int FIXED = 8 * 4 + 2 * NUP * KY * KX * 4 + 2 * KW * 4
                                 + 2 * KG * 4 + KNB * KX * 4 + SUB_BYTES
                                 + CNT_BYTES;
    static constexpr int bytes(int ring) {
        return ring * SLOT + FIXED + (BULK ? 128 : 0);
    }
    // four levels where two blocks of them fit on an SM, else three
    static constexpr int RING =
        BLOCKS_PER_SM * (bytes(4) + SMEM_RESERVED) <= SMEM_SM ? 4 : 3;
    // SAVE_BULK at idrv=1 in the keeps_ddt modes: a step's d/dT
    // derivatives staged for bulk tensor stores, two (KG, KX) tiles after
    // the ring, and the mbarrier that frees them, where two blocks still
    // fit an SM with them at the ring's depth (banded, cldf-odcld; fused,
    // compact and maxrand store them from the registers)
    static constexpr int PTILES = 2 * KG * KX * 4;
    static constexpr bool PBULK =
        BULK && IDRV && keeps_ddt(MODE)
        && BLOCKS_PER_SM * (bytes(RING) + PTILES + 16 + SMEM_RESERVED)
               <= SMEM_SM;
    static constexpr int PST = RING * SLOT;           // PBULK: the tiles,
    static constexpr int PFREE = PST + (PBULK ? PTILES : 0);  // mbarrier
    static constexpr int BYTES = bytes(RING) + (PBULK ? PTILES + 16 : 0);
    static constexpr int BAR = PFREE + (PBULK ? 16 : 0);  // 8 B each
    static constexpr int PART = BAR + 8 * 4;
    static constexpr int CLYW = PART + 2 * NUP * KY * KX * 4;
    static constexpr int NGB = CLYW + 2 * KW * 4;
    static constexpr int WG = NGB + KG * 4;
    static constexpr int SECD = WG + KG * 4;             // (16, KX)
    static constexpr int SUB = SECD + KNB * KX * 4;      // (3, KGPT, KT)
    static constexpr int CNT = SUB + SUB_BYTES;          // (KT)
};

// The per-g cloud fraction of g at column c of a staged level: the
// compact mask or the cldfmc array.
template <int MODE, int SPEC>
__device__ __forceinline__ float staged_cf(const unsigned char* s, int g,
                                           int c) {
    using Sl = Slot<MODE, SPEC>;
    if constexpr (MODE == COMPACT)
        return (float)reinterpret_cast<const int8_t*>(s + Sl::CLD)[g * KX + c];
    else
        return reinterpret_cast<const float*>(s + Sl::CLD)[g * KX + c];
}

// The factors of one sweep step of (layer l, g, column c) from the staged
// level s (rtrn.py precompute's arithmetic, operation for operation, as
// K6's step_bwd recomputes it),
// with the cloud terms only where the g-point is cloudy.  `cf` is the
// cloud fraction of this g (COMPACT: the mask value; FUSED, CLDF_OD:
// cldfmc) or the layer's (BANDED, MAXRAND); b the global column.
// CLOUDS false: the gas factors alone, for a level where no column of
// the tile is cloudy (the recurrences then read nothing else).
template <int MODE, int SPEC, bool CLOUDS, typename In>
__device__ __forceinline__ Step staged_step(const unsigned char* s,
                                            const In& in, int l, int g,
                                            int bd, float secd, float cf,
                                            float cw0, float cw1, int c,
                                            int b) {
    using Sl = Slot<MODE, SPEC>;
    const size_t B = in.B;
    const int gi = g * KX + c, bi_s = bd * KX + c;
    const float* bc = reinterpret_cast<const float*>(s + Sl::BC);
    const float fr = rrtm::spec_load<SPEC, false>(
        reinterpret_cast<const float*>(s + Sl::FR), gi);
    const float bl = reinterpret_cast<const float*>(s + Sl::PLAY)[bi_s];
    const float dp =
        reinterpret_cast<const float*>(s + Sl::PLEV)[bi_s] - bl;
    float tau = rrtm::spec_load<SPEC, true>(
        reinterpret_cast<const float*>(s + Sl::TAU), gi);
    if constexpr (SPEC != rrtm::SPEC_F32)
        tau = tau + reinterpret_cast<const float*>(s + Sl::TAUA)[bi_s];
    const float od = fmaxf(secd * tau, 0.0f);
    float tfg;
    Step f;
    gas_factors(od, f.at, tfg);
    f.src = fr * (bl + tfg * dp);
    f.atot = f.at;
    f.ef = f.cf = 0.0f;
    f.srctot = f.src;
    if constexpr (CLOUDS && per_g_clouds(MODE)) {
        f.cf = cf;
        float odce = 0.0f;
        const bool gate = cf >= 0.5f;
        if (gate) {
            float odcld;
            if constexpr (MODE == COMPACT) {
                // cldprmc on the compact products (mask x layer water path)
                const size_t bi = ((size_t)l * rrtm::NBAND + bd) * B + b;
                const float ciwp = cw0 * cf;
                const float clwp = cw1 * cf;
                const float ai = ciwp == 0.0f ? 0.0f : in.abi[bi];
                const float al = clwp == 0.0f ? 0.0f : in.abl[bi];
                const float cwp = ciwp + clwp;
                const bool active = cf >= CLDMIN && cwp >= CLDMIN;
                odcld = active ? ciwp * ai + clwp * al : 0.0f;
            } else {
                const size_t pi = ((size_t)l * rrtm::NGPT_PAD + g) * B + b;
                if constexpr (MODE == CLDF_OD) {
                    odcld = in.tauc[pi];
                } else {
                    // cldprmc (rrtmg_lw_cldprmc.f90:128-142) inline
                    const float ciwp = in.ciwp[pi];
                    const float clwp = in.clwp[pi];
                    const float tauc = in.tauc[pi];
                    const float ai = ciwp == 0.0f ? 0.0f : bc[bi_s];
                    const float al =
                        clwp == 0.0f ? 0.0f : bc[KNB * KX + bi_s];
                    const float cwp = ciwp + clwp;
                    const bool active =
                        cf >= CLDMIN && (cwp >= CLDMIN || tauc >= CLDMIN);
                    odcld = active ? ciwp * ai + clwp * al : tauc;
                }
            }
            odce = secd * odcld;
            f.ef = (1.0f - expf(-odce)) * cf;
        }
        // clear g-point: the total-sky factors are the gas factors, but
        // at od == 0.06 where tot_factors takes its other branch
        if (gate || od == 0.06f) {
            float tft;
            tot_factors(od + odce, f.atot, tft);
            f.srctot = fr * (bl + tft * dp);
        }
    } else if constexpr (CLOUDS && (MODE == BANDED || MODE == MAXRAND)) {
        if (cf >= CLOUD_GATE) {
            // per-band cloud od of this g's band, on the spectral band's
            // diffusivity
            const float odce = secd * bc[bi_s];
            if (MODE == BANDED) f.ef = (1.0f - expf(-odce)) * cf;
            f.cf = cf;
            float tft;
            tot_factors(od + odce, f.atot, tft);
            f.srctot = fr * (bl + tft * dp);
        }
    }
    return f;
}

// What K1 keeps in the gradient step besides rads and packed: the
// per-g modes' cloudy-layer words and, SAVE_BULK, the tensor maps of
// taut and fracs (L x 140 rows) and of rads (2 | 4 x L x 140 rows), boxes
// of 16 columns x 140 rows
struct KeptArgs {
    CUtensorMap taut, fracs, rads;
    uint16_t* words;
};
struct NoKept {};
template <int SAVE>
using KeptOf = std::conditional_t<SAVE == NO_SAVE, NoKept, KeptArgs>;

// the thread that issues SAVE_BULK's bulk copies and writes the words:
// lane 0 of the last warp (warps 0-1 reduce the flux partials)
constexpr int ELECT = KT - 32;

// SAVE (float32; the gradient step): the
// kernel also writes the per-g radiances it sums into the flux rows to
// rads (2 | 4, L, 140, B), row D the down radiance at level l after
// layer l, row U the up radiance entering layer l (l = 0: just after the
// surface reflection), the cloudy modes rows 2-3 their clear twins; and
// maxrand the cloudy, clear and correction sub-streams (cr, kr, rr)
// entering layer l in the down (up) sweep where layer l is cloudy and
// does not restart them in that sweep, to packed (2, 3, npk, 140, B): a
// column's k-th such layer in the sweep's order (down: from the top) at
// slot k (slots past its count are left as they were); K6 reads them
// back there; fused, cldf-odcld and compact at idrv=1 the cloudy-layer
// words to kept.words ((tiles of 32 columns, L) uint32); banded, maxrand,
// fused, cldf-odcld and compact at idrv=1 (keeps_ddt) the d/dT derivative
// entering layer l and its clear twin to rads' planes P_DDT, P_DDT + 1
// (rads then (6, L, 140, B)).  Elsewhere rads and packed are not read.
template <int MODE, bool IDRV, int SPEC, int SAVE>
__global__ void __launch_bounds__(KT, BLOCKS_PER_SM)
rt_kernel(KernelInputs<SPEC> in, const int* __restrict__ ngb,
          const float* __restrict__ wg, float* __restrict__ out,
          float* __restrict__ rads, float* __restrict__ packed, int npk,
          __grid_constant__ const KeptOf<SAVE> kept) {
    constexpr bool KEEP = SAVE != NO_SAVE;
    constexpr bool BULK = SAVE == SAVE_BULK;
    // the d/dT derivatives kept too
    constexpr bool KEEP_P = KEEP && IDRV && keeps_ddt(MODE);
    using Sl = Slot<MODE, SPEC>;
    using Lo = Layout<MODE, IDRV, SPEC, BULK>;
    constexpr bool MR = MODE == MAXRAND;
    constexpr bool PERG = per_g_clouds(MODE);
    constexpr int ND = IDRV ? KGPT : 1;     // d/dT carries (idrv)
    constexpr int NUP = Lo::NUP;            // flux rows of the up sweep
    constexpr int RING = Lo::RING;
    constexpr int ES = Sl::ES;
    static_assert(!KEEP || SPEC == rrtm::SPEC_F32,
                  "radiances are kept for K6 in float32 only");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = smem_raw;
    if constexpr (BULK)                     // the ring at a 128-byte boundary
        smem += (128u - (smem_addr(smem_raw) & 127u)) & 127u;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + Lo::BAR);
    // PBULK: the staged d/dT derivatives, P then PC, and their mbarrier
    [[maybe_unused]] float* pst = reinterpret_cast<float*>(smem + Lo::PST);
    [[maybe_unused]] uint64_t* pfree =
        reinterpret_cast<uint64_t*>(smem + Lo::PFREE);
    float* part = reinterpret_cast<float*>(smem + Lo::PART);
    unsigned* clyw = reinterpret_cast<unsigned*>(smem + Lo::CLYW);
    int* ngb_s = reinterpret_cast<int*>(smem + Lo::NGB);
    float* wg_s = reinterpret_cast<float*>(smem + Lo::WG);
    float* secd_s = reinterpret_cast<float*>(smem + Lo::SECD);
    float* sub = reinterpret_cast<float*>(smem + Lo::SUB);
    int* cnt = reinterpret_cast<int*>(smem + Lo::CNT);

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * KX + tx;
    const int L = in.L, B = in.B;
    const int bt = blockIdx.x * KX;
    const int nvalid = min(KX, B - bt);
    const bool valid = tx < nvalid;
    const int c = valid ? tx : nvalid - 1;  // ragged edge: compute, never write
    const int b = bt + c;
    for (int i = tid; i < KG; i += KT) {
        ngb_s[i] = ngb[i];
        wg_s[i] = wg[i];
    }
    static_assert(KNB * KX == KT, "one secant a thread");
    secd_s[tid] = in.surf[(size_t)(tid / KX) * B + bt
                          + min(tid % KX, nvalid - 1)];
    if (tid == 0) {
        // SAVE_BULK: and the elected thread's bulk loads' arrival
        for (int r = 0; r < RING; ++r) mbar_init(&bar[r], KT + BULK);
        if constexpr (Lo::PBULK) mbar_init(pfree, 1);
        if constexpr (BULK) fence_mbarrier_init();
    }

    // 16-byte copies of a full tile where each array's rows allow them
    const bool full = nvalid == KX;
    const bool v_spec = full && rows16<ES>(in.taut, B)
                        && rows16<ES>(in.fracs, B);
    bool v_band = full && rows16<4>(in.play, B) && rows16<4>(in.plev, B);
    bool v_cld = full;
    if constexpr (SPEC != rrtm::SPEC_F32)
        v_band = v_band && rows16<4>(in.taua, B);
    if constexpr (MODE == FUSED)
        v_band = v_band && rows16<4>(in.abi, B) && rows16<4>(in.abl, B);
    else if constexpr (MODE == BANDED || MR)
        v_band = v_band && rows16<4>(in.taucb, B);
    if constexpr (MODE == COMPACT)
        v_cld = full && rows16<1>(in.mask, B) && rows16<4>(in.cw, B);
    else if constexpr (PERG)
        v_cld = full && rows16<4>(in.cldf, B);
    else if constexpr (MODE == BANDED || MR)
        v_cld = full && rows16<4>(in.cld, B);
    const size_t Bz = B;

    // copy the inputs of step j (down sweep: layer L-1-j, Planck level
    // the same; up sweep j = L + l: layer l, Planck level l+1) into its
    // slot, and arm the slot's mbarrier with this thread's copies
    auto stage_step = [&](int j) {
        const bool up = j >= L;
        const int l = up ? j - L : L - 1 - j;
        const int lev = up ? l + 1 : l;
        unsigned char* s = smem + (j % RING) * Lo::SLOT;
        const int tid = opaque(threadIdx.y * KX + threadIdx.x);
        if constexpr (BULK) {
            // taut and fracs by bulk tensor loads, once the stores from
            // the slot's tiles have read them
            if (tid == ELECT) {
                uint64_t* mb = &bar[j % RING];
                mbar_arrive_expect_tx(mb, 2 * KG * KX * 4);
                bulk_wait_all<true>();
                tma_load_2d(s + Sl::TAU, &kept.taut, bt, l * KG, mb);
                tma_load_2d(s + Sl::FR, &kept.fracs, bt, l * KG, mb);
            }
        } else {
            const auto* taut = reinterpret_cast<const unsigned char*>(in.taut);
            const auto* fracs =
                reinterpret_cast<const unsigned char*>(in.fracs);
            const size_t gr = ((size_t)l * KG * Bz + bt) * ES;
            stage<ES>(s + Sl::TAU, taut + gr, KG, Bz * ES, nvalid, v_spec,
                      tid);
            stage<ES>(s + Sl::FR, fracs + gr, KG, Bz * ES, nvalid, v_spec,
                      tid);
        }
        auto band_rows = [&](int off, const float* p, int row0, int rows) {
            stage<4>(s + off,
                     reinterpret_cast<const unsigned char*>(
                         p + (size_t)row0 * Bz + bt),
                     rows, Bz * 4, nvalid, v_band, tid);
        };
        band_rows(Sl::PLAY, in.play, l * KNB, KNB);
        band_rows(Sl::PLEV, in.plev, lev * KNB, KNB);
        if constexpr (SPEC != rrtm::SPEC_F32)
            band_rows(Sl::TAUA, in.taua, l * KNB, KNB);
        if constexpr (MODE == FUSED) {
            band_rows(Sl::BC, in.abi, l * KNB, KNB);
            band_rows(Sl::BC + KNB * Sl::BAND_ROW, in.abl, l * KNB, KNB);
        } else if constexpr (MODE == BANDED || MR) {
            band_rows(Sl::BC, in.taucb, l * KNB, KNB);
        }
        if constexpr (MODE == COMPACT) {
            stage<1>(s + Sl::CLD,
                     reinterpret_cast<const unsigned char*>(
                         in.mask + (size_t)l * rrtm::NGPT_PAD * Bz + bt),
                     KG, Bz, nvalid, v_cld, tid);
            stage<4>(s + Sl::CW,
                     reinterpret_cast<const unsigned char*>(
                         in.cw + (size_t)l * 2 * Bz + bt),
                     2, Bz * 4, nvalid, v_cld, tid);
        } else if constexpr (PERG) {
            stage<4>(s + Sl::CLD,
                     reinterpret_cast<const unsigned char*>(
                         in.cldf + (size_t)l * rrtm::NGPT_PAD * Bz + bt),
                     KG, Bz * 4, nvalid, v_cld, tid);
        } else if constexpr (MODE == BANDED) {
            stage<4>(s + Sl::CLD,
                     reinterpret_cast<const unsigned char*>(
                         in.cld + (size_t)l * Bz + bt),
                     1, Bz * 4, nvalid, v_cld, tid);
        } else if constexpr (MR) {
            stage<4>(s + Sl::CLD,
                     reinterpret_cast<const unsigned char*>(
                         in.cld + (size_t)l * NROW * Bz + bt),
                     NROW, Bz * 4, nvalid, v_cld, tid);
        }
        mbar_arrive_copies(&bar[j % RING]);
    };
    auto slot = [&](int j) -> unsigned char* {
        return smem + (j % RING) * Lo::SLOT;
    };
    auto wait_step = [&](int j) {
        mbar_wait(&bar[j % RING], (unsigned)(j / RING) & 1u);
    };
    // per-g modes: this warp's ballot of the columns with a cloudy g-point
    // at step j, into clyw[j & 1]
    const int warp = tid >> 5, lane = tid & 31;
    auto ballot_step = [&](int j) {
        if constexpr (PERG) {
            const unsigned char* s = slot(j);
            bool mine = false;
#pragma unroll
            for (int k = 0; k < KGPT; ++k) {
                const int g = ty + k * KY;
                if (g < KG) mine |= staged_cf<MODE, SPEC>(s, g, c) >= 0.5f;
            }
            const unsigned bal = __ballot_sync(0xffffffffu, mine && valid);
            if (lane == 0) clyw[(j & 1) * KW + warp] = bal;
        }
    };
    // the column's flag at step j: the OR of the warps' ballots, whose
    // lanes 16-31 hold the odd g-lanes of the same 16 columns
    auto cloudy_word = [&](int j) {
        unsigned w = 0u;
#pragma unroll
        for (int i = 0; i < KW; ++i) w |= clyw[(j & 1) * KW + i];
        return w | (w >> 16);
    };
    auto cloudy_step = [&](int j) {
        return ((cloudy_word(j) >> tx) & 1u) != 0u;
    };
    // SAVE, fused, cldf-odcld and compact at idrv=1: the block's half of
    // its tile's word at down step j's layer (the last block of an odd
    // count: the whole word, its high half zero)
    auto put_word = [&](int j) {
        if constexpr (KEEP) {
            const unsigned w = cloudy_word(j) & 0xffffu;
            const int u = blockIdx.x;
            const size_t wi = (size_t)(u >> 1) * L + (L - 1 - j);
            if ((u & 1) == 0 && u + 1 == (int)gridDim.x)
                reinterpret_cast<unsigned*>(kept.words)[wi] = w;
            else
                kept.words[2 * wi + (u & 1)] = (uint16_t)w;
        }
    };
    // sum the g-lanes' partials p (nrow rows) of each column in a fixed
    // order into flux rows r[0..nrow) at level lev
    auto reduce_write = [&](const float* p, int nrow, int r0, int r1, int r2,
                            int r3, int lev) {
        const int t = opaque(tid);
        if (t < nrow * KX) {
            const int row = t / KX, col = t - row * KX;
            if (col < nvalid) {
                float acc = 0.0f;
#pragma unroll
                for (int y = 0; y < KY; ++y) acc += p[(row * KY + y) * KX + col];
                const int r = row == 0 ? r0 : row == 1 ? r1 : row == 2 ? r2
                                                                        : r3;
                out[((size_t)r * (L + 1) + lev) * Bz + bt + col] = acc;
            }
        }
    };
    auto part_buf = [&](int j) { return part + (j & 1) * NUP * KY * KX; };
    auto put_part = [&](int j, const auto& sacc) {
        constexpr int nrow = sizeof(sacc) / sizeof(float);
        float* p = part_buf(j);
#pragma unroll
        for (int r = 0; r < nrow; ++r) p[(r * KY + ty) * KX + tx] = sacc[r];
    };

    // prologue of a sweep whose first step is j0 of n: stage RING - 1
    // steps, then the first step's flags
    auto prologue = [&](int j0, int n) {
        for (int j = j0; j < j0 + RING - 1 && j < j0 + n; ++j) stage_step(j);
        __syncthreads();
        wait_step(j0);
        ballot_step(j0);
        __syncthreads();
    };

    __syncthreads();                        // ngb_s, wg_s, the mbarriers
    float rad[KGPT], radc[KGPT], dl[ND], dc[ND];
#pragma unroll
    for (int k = 0; k < KGPT; ++k) rad[k] = radc[k] = 0.0f;
    // maxrand's sub-streams of g-point k: cr, kr, rr
    auto subs = [&](int q, int k) -> float& {
        return sub[(q * KGPT + k) * KT + tid];
    };
    // SAVE: radiance row `row` (D or U) of g-point k of this thread at
    // layer l, and in a cloudy mode its clear twin at row + 2.
    // SAVE_SCALAR: to rads, valid columns only; SAVE_BULK: over this
    // thread's own cells of the step's TAU and FR tiles in slot s (lanes
    // past the ragged edge write cells no one reads, and the store clips)
    auto save = [&](int row, int l, int k, unsigned char* s) {
        if constexpr (BULK) {
            const int i = (ty + k * KY) * KX + tx;
            reinterpret_cast<float*>(s + Sl::TAU)[i] = rad[k];
            if constexpr (MODE != CLEAR)
                reinterpret_cast<float*>(s + Sl::FR)[i] = radc[k];
        } else if (valid) {
            const size_t lgb = (size_t)L * KG * Bz;
            float* p = rads + row * lgb
                       + ((size_t)l * KG + ty + k * KY) * Bz + b;
            *p = rad[k];
            if constexpr (MODE != CLEAR) p[2 * lgb] = radc[k];
        }
    };
    // KEEP_P: the d/dT derivative of g-point k entering layer l and its
    // clear twin to rads' planes P_DDT, P_DDT + 1: PBULK over this
    // thread's cells of the staged tiles (lanes past the ragged edge
    // write cells the store clips), else by scalar stores, valid columns
    // only
    auto save_ddt = [&](int l, int k) {
        if constexpr (Lo::PBULK) {
            const int i = (ty + k * KY) * KX + tx;
            pst[i] = dl[k];
            pst[KG * KX + i] = dc[k];
        } else if constexpr (KEEP_P) {
            if (valid) {
                const size_t lgb = (size_t)L * KG * Bz;
                // one product for the address (other forms of it spilled
                // in fused and cldf-odcld's bulk path at 128 registers)
                float* p = rads + ((size_t)(P_DDT * L + l) * KG + ty + k * KY)
                                  * Bz + b;
                *p = dl[k];
                p[lgb] = dc[k];
            }
        }
    };
    // SAVE_BULK, the elected thread: step j's tiles to rads by bulk tensor
    // stores, one bulk group (row D of the down sweep's layer, U of the
    // up sweep's, and their clear twins two planes on)
    auto store_step = [&](int j) {
        if constexpr (BULK) {
            if (tid != ELECT) return;
            const bool up = j >= L;
            const int l = up ? j - L : L - 1 - j;
            const unsigned char* s = slot(j);
            // the L2's normal policy (evict first measured no faster,
            // k1save_variants "evict")
            const uint64_t pol = l2_policy(false);
            const int y = ((up ? 1 : 0) * L + l) * KG;
            tma_store_2d(&kept.rads, s + Sl::TAU, bt, y, pol);
            if constexpr (MODE != CLEAR)
                tma_store_2d(&kept.rads, s + Sl::FR, bt, y + 2 * L * KG, pol);
            if constexpr (Lo::PBULK) {
                if (up) {
                    const int yp = (P_DDT * L + l) * KG;
                    tma_store_2d(&kept.rads, pst, bt, yp, pol);
                    tma_store_2d(&kept.rads, pst + KG * KX, bt, yp + L * KG,
                                 pol);
                }
            }
            bulk_commit();
        }
    };
    // SAVE, maxrand: the sub-streams of g-point k entering the layer, at
    // the column's slot of the sweep (its kept layers before this one,
    // counted in cnt) of the packed rows, down sweep 0, up 1
    auto save_subs = [&](bool upw, int k) {
        const int slot = cnt[tid];
        if (valid && slot < npk) {
            const size_t kgb = (size_t)npk * KG * Bz;
            float* p = packed + (upw ? 3 : 0) * kgb
                       + ((size_t)slot * KG + ty + k * KY) * Bz + b;
#pragma unroll
            for (int q = 0; q < 3; ++q) p[q * kgb] = subs(q, k);
        }
    };
    auto zero_subs = [&] {
        if constexpr (MR) {
#pragma unroll
            for (int k = 0; k < KGPT; ++k)
                subs(0, k) = subs(1, k) = subs(2, k) = 0.0f;
            if constexpr (KEEP) cnt[tid] = 0;
        }
    };
    zero_subs();

    // One sweep, down (layer L-1 .. 0, radiance at each layer bottom;
    // steps 0 .. L-1, flux rows DOWN, CLR_DOWN) or up (layer 0 .. L-1,
    // radiance at each layer top; steps L .. 2L-1, rows UP, CLR_UP and at
    // idrv=1 D_UP, D_CLR_UP).  The clear twin follows the clear
    // recurrence below the first cloudy layer from the top (down: the
    // running iclddn) or in a column with any cloud (up: anyc).
    bool icl = false;                      // cloud in path above (iclddn)
    auto sweep = [&](auto upward, bool anyc) {
        constexpr bool UPW = decltype(upward)::value;
        constexpr int NR = UPW ? NUP : 2;
        const int j0 = UPW ? L : 0;
        // the partial fluxes of step j, at the level its layer bounds; up
        // step L - 1 is the surface's, at level 0
        auto flush = [&](int j) {
            if (UPW)
                reduce_write(part_buf(j), NUP, UP, CLR_UP, D_UP, D_CLR_UP,
                             j - L + 1);
            else
                reduce_write(part_buf(j), 2, DOWN, CLR_DOWN, 0, 0, L - 1 - j);
        };
        prologue(j0, L);
        for (int j = j0; j < j0 + L; ++j) {
            if (j > j0) store_step(j - 1);
            if (UPW || j > j0) flush(j - 1);
            if (j + RING - 1 < j0 + L) stage_step(j + RING - 1);
            // PBULK: the staged derivatives free once the previous step's
            // bulk stores have read them
            if constexpr (Lo::PBULK && UPW) {
                if (tid == ELECT) {
                    bulk_wait_all<true>();
                    mbar_arrive(pfree);
                }
            }
            const int l = UPW ? j - L : L - 1 - j;
            unsigned char* s = slot(j);
            bool cly = false, ist = false;
            float cw0 = 0.0f, cw1 = 0.0f, cf = 0.0f, fac[6];
            const float* cld = reinterpret_cast<const float*>(s + Sl::CLD);
            if constexpr (PERG) {
                cly = cloudy_step(j);
                if constexpr (KEEP && (MODE != COMPACT || IDRV) && !UPW)
                    if (tid == ELECT) put_word(j);
                if constexpr (MODE == COMPACT) {
                    const float* cw =
                        reinterpret_cast<const float*>(s + Sl::CW);
                    cw0 = cw[c];
                    cw1 = cw[KX + c];
                }
            } else if constexpr (MODE == BANDED) {
                cf = cld[c];
                cly = cf >= CLOUD_GATE;
            } else if constexpr (MR) {
                cf = cld[R_CLDF * KX + c];
                cly = cf >= CLOUD_GATE;
                ist = cld[(UPW ? R_IST_UP : R_IST_DN) * KX + c] > 0.0f;
#pragma unroll
                for (int i = 0; i < 6; ++i)
                    fac[i] = cld[((UPW ? R_UP : R_DN) + i) * KX + c];
            }
            if constexpr (!UPW)
                icl = MR ? cld[R_ICLDDN * KX + c] > 0.0f : icl || cly;
            const bool twin = UPW ? anyc : icl;
            float sacc[NR] = {};
            auto steps = [&](auto clouds) {
                constexpr bool CL = decltype(clouds)::value;
#pragma unroll
                for (int k = 0; k < KGPT; ++k) {
                    const int g = ty + k * KY;
                    if (g >= KG) continue;
                    const float cfg =
                        CL && PERG ? staged_cf<MODE, SPEC>(s, g, c) : cf;
                    const int bd = ngb_s[g];
                    const Step f = staged_step<MODE, SPEC, CL>(
                        s, in, l, g, bd, secd_s[bd * KX + c], cfg, cw0, cw1,
                        c, b);
                    // SAVE_BULK, the ragged tile: the lanes past its edge
                    // read column nvalid - 1's cells of this g before that
                    // column's lane writes over them
                    if constexpr (BULK)
                        if (!full) __syncwarp();
                    if constexpr (KEEP && UPW) save(1, l, k, s);  // entering l
                    if constexpr (KEEP_P && UPW) {
                        if constexpr (Lo::PBULK)
                            if (k == 0)
                                mbar_wait(pfree, (unsigned)(j - L) & 1u);
                        save_ddt(l, k);
                    }
                    if constexpr (KEEP && MR)
                        if (cly && !ist) save_subs(UPW, k);
                    if constexpr (MR)
                        advance_mr(rad[k], radc[k], subs(0, k), subs(1, k),
                                   subs(2, k), f, CL && cly, twin, ist, fac);
                    else
                        advance(rad[k], radc[k], f, CL && cly, twin);
                    if constexpr (KEEP && !UPW) save(0, l, k, s);  // level l
                    sacc[0] += wg_s[g] * rad[k];
                    sacc[1] += wg_s[g] * radc[k];
                    if constexpr (UPW && IDRV) {
                        advance_ddt(dl[k], dc[k], f, CL && cly, twin);
                        sacc[2] += wg_s[g] * dl[k];
                        sacc[3] += wg_s[g] * dc[k];
                    }
                }
            };
            // every warp holds all KX columns: the branch is block-uniform
            if (__any_sync(0xffffffffu, cly))
                steps(std::true_type{});
            else
                steps(std::false_type{});
            if constexpr (KEEP && MR)
                if (cly && !ist) ++cnt[tid];
            put_part(j, sacc);
            if (j + 1 < j0 + L) {
                wait_step(j + 1);
                ballot_step(j + 1);
            }
            // SAVE_BULK: the tiles written before the stores read them
            if constexpr (BULK) fence_proxy_async_smem();
            __syncthreads();
        }
        store_step(j0 + L - 1);
        flush(j0 + L - 1);
    };

    sweep(std::false_type{}, false);
    if (tid < 2 * KX && tid % KX < nvalid) {  // nothing comes down at the top
        const int r = tid < KX ? DOWN : CLR_DOWN;
        out[((size_t)r * (L + 1) + L) * Bz + bt + tid % KX] = 0.0f;
    }
    __syncthreads();                        // part_buf(L - 1) read

    // ---- surface reflection (and the d/dT seed), as up step L - 1 ----
    {
        float sacc[NUP] = {};
#pragma unroll
        for (int k = 0; k < KGPT; ++k) {
            const int g = ty + k * KY;
            if (g >= KG) continue;
            const float fr0 =
                rrtm::spec_load<SPEC, false>(in.fracs, (size_t)g * Bz + b);
            const int bd = ngb_s[g];
            const float rad0 =
                fr0 * in.surf[((size_t)2 * rrtm::NBAND + bd) * Bz + b];
            const float reflect =
                1.0f - in.surf[((size_t)rrtm::NBAND + bd) * Bz + b];
            rad[k] = rad0 + reflect * rad[k];
            radc[k] = rad0 + reflect * radc[k];
            sacc[0] += wg_s[g] * rad[k];
            sacc[1] += wg_s[g] * radc[k];
            if constexpr (IDRV) {
                const float d0 =
                    fr0 * in.surf[((size_t)3 * rrtm::NBAND + bd) * Bz + b];
                dl[k] = dc[k] = d0;
                sacc[2] += wg_s[g] * d0;
                sacc[3] += wg_s[g] * d0;
            }
        }
        put_part(L - 1, sacc);
    }
    zero_subs();
    // any cloudy layer in the column: maxrand reads iclddn of layer 0
    sweep(std::true_type{},
          MR ? in.cld[(size_t)R_ICLDDN * Bz + b] > 0.0f : icl);
    // SAVE_BULK: the stores done before the block's shared memory goes
    if constexpr (BULK)
        if (tid == ELECT) bulk_wait_all<false>();
}

// the dynamic shared memory of an instantiation
template <int MODE, bool IDRV, int SPEC, int SAVE>
constexpr int kernel_smem() {
    return Layout<MODE, IDRV, SPEC, SAVE == SAVE_BULK>::BYTES;
}

// the shared memory attributes of an instantiation, set once per process
template <int MODE, bool IDRV, int SPEC, int SAVE>
cudaError_t prepare() {
    static const cudaError_t e =
        tile_smem(rt_kernel<MODE, IDRV, SPEC, SAVE>,
                  kernel_smem<MODE, IDRV, SPEC, SAVE>());
    return e;
}

template <int MODE, bool IDRV, int SPEC, int SAVE>
cudaError_t launch(const KernelInputs<SPEC>& in, const int* ngb,
                   const float* wg, float* out, const Kept& kp,
                   const KeptOf<SAVE>& ka, cudaStream_t s) {
    cudaError_t e = prepare<MODE, IDRV, SPEC, SAVE>();
    if (e != cudaSuccess) return e;
    const dim3 block(KX, KY);
    const dim3 grid((in.B + KX - 1) / KX);
    rt_kernel<MODE, IDRV, SPEC, SAVE>
        <<<grid, block, kernel_smem<MODE, IDRV, SPEC, SAVE>(), s>>>(
            in, ngb, wg, out, kp.rads, kp.packed, kp.npk, ka);
    return cudaGetLastError();
}

// K1 at idrv as the forward step runs it
template <int MODE, int SPEC>
cudaError_t launch(const KernelInputs<SPEC>& in, const int* ngb,
                   const float* wg, float* out, int idrv, cudaStream_t s) {
    return idrv ? launch<MODE, true, SPEC, NO_SAVE>(in, ngb, wg, out, Kept{},
                                                    NoKept{}, s)
                : launch<MODE, false, SPEC, NO_SAVE>(in, ngb, wg, out,
                                                     Kept{}, NoKept{}, s);
}

// the launch configuration of an instantiation (tile_info)
template <int MODE, bool IDRV, int SPEC, int SAVE>
cudaError_t info(int* out) {
    cudaError_t e = prepare<MODE, IDRV, SPEC, SAVE>();
    if (e != cudaSuccess) return e;
    return tile_info(rt_kernel<MODE, IDRV, SPEC, SAVE>,
                     kernel_smem<MODE, IDRV, SPEC, SAVE>(),
                     Layout<MODE, IDRV, SPEC, SAVE == SAVE_BULK>::RING, out);
}

template <int MODE, int SPEC>
cudaError_t info(int idrv, int* out) {
    return idrv ? info<MODE, true, SPEC, NO_SAVE>(out)
                : info<MODE, false, SPEC, NO_SAVE>(out);
}

template <int SPEC>
cudaError_t info_storage(int mode, int idrv, int* out) {
    switch (mode) {
    case CLEAR: return info<CLEAR, SPEC>(idrv, out);
    case COMPACT: return info<COMPACT, SPEC>(idrv, out);
    case BANDED: return info<BANDED, SPEC>(idrv, out);
    case MAXRAND: return info<MAXRAND, SPEC>(idrv, out);
    case FUSED: return info<FUSED, SPEC>(idrv, out);
    case CLDF_OD: return info<CLDF_OD, SPEC>(idrv, out);
    default: return cudaErrorInvalidValue;
    }
}

// are the cloud inputs of `mode` given
inline bool clouds_given(const Inputs& in, int mode) {
    switch (mode) {
    case CLEAR: return true;
    case COMPACT: return in.mask && in.cw && in.abi && in.abl;
    case BANDED:
    case MAXRAND: return in.cld && in.taucb;
    case FUSED:
        return in.cldf && in.ciwp && in.clwp && in.tauc && in.abi && in.abl;
    case CLDF_OD: return in.cldf && in.tauc;
    default: return false;
    }
}

// K1 in `mode` (enum Mode) with taut / fracs in storage SPEC, as the
// forward step runs it; checks that the mode's cloud inputs (and, in
// reduced storage, taua) are given
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
    if (!clouds_given(in, mode)) return cudaErrorInvalidValue;
    switch (mode) {
    case CLEAR: return launch<CLEAR, SPEC>(in, ngb, wg, out, idrv, s);
    case COMPACT: return launch<COMPACT, SPEC>(in, ngb, wg, out, idrv, s);
    case BANDED: return launch<BANDED, SPEC>(in, ngb, wg, out, idrv, s);
    case MAXRAND: return launch<MAXRAND, SPEC>(in, ngb, wg, out, idrv, s);
    case FUSED: return launch<FUSED, SPEC>(in, ngb, wg, out, idrv, s);
    case CLDF_OD: return launch<CLDF_OD, SPEC>(in, ngb, wg, out, idrv, s);
    default: return cudaErrorInvalidValue;
    }
}

}  // namespace
