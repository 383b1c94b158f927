// K6 in the banded, fused and cldf-odcld modes: the adjoint of K1's
// random-overlap sweep of per-band clouds (banded, icld=1) and of McICA
// per-g clouds (fused: cldprmc inline, inflag=2; cldf-odcld: the per-g
// cloud od given, inflag=0), at idrv = 0 or 1: flux cotangents (4, L+1, B)
// (at idrv=1 with a cotangent of the d/dT outputs, (2, L+1, B), the
// instantiation rt_bwd_g_ddt_kernel, which also runs their adjoint, as
// K6's in rtrn_bwd.cu does, and takes and gives the fourth surface row) ->
// cotangents of taut, fracs (L, 140, B), planklay (L, 16, B), planklev
// (L+1, 16, B), the surface rows (3, 16, B) and the mode's cloud inputs:
//   banded:     cldfrac (L, B), the per-band cloud od taucb (L, 16, B);
//   cldf-odcld: cldf, odcld (L, 144, B);
//   fused:      cldf, ciwp, clwp, tauc (L, 144, B), abi, abl (L, 16, B);
// the pad rows 140-143 of every (L, 144, B) cotangent zero.  And K6 in
// the compact mode (McICA's int8 mask x the layer's water paths) in its
// d/dT instantiation alone (rt_bwd_g_ddt_kernel<COMPACT>; its idrv=0
// kernel is rtrn_bwd.cu's): cotangents of cw (L, 2, B), abi, abl (L, 16,
// B); the mask carries none.
//
// Replaces the JAX package's backward of these sweeps, which is XLA's
// autodiff of rtrn.rt_random_overlap (rrtmg_lw_tpu/ops/rtrn_pallas.py:1040,
// bwd of the Pallas RT sweep; its unrolled backward, ops/rtrn_bwd.py:78-83,
// excludes these modes); there is no Pallas original.  It linearizes K1's
// own forward (rtrn.cuh advance, rtrn_kernel.cuh staged_step), so the
// plain vjps of rtrn.rt_sweep_banded and rtrn.rt_sweep_blocked are its
// exact reference.
//
// The sweeps are linear in the carried radiances, so the adjoint runs the
// up sweep in reverse (top layer down), the surface reflection, then the
// down sweep in reverse (surface up), carrying per (column, g) the
// cotangents of the total-sky radiance (lam) and of its clear twin (mu).
// The radiances each reverse step needs, those entering its layer, come
// from K1's gradient-step launch (SAVE, rtrn_kernel.cuh: rads (4, L, 140,
// B), D, U and their clear twins; at idrv=1 (6, L, 140, B), the d/dT
// derivatives P, PC too); the factors of each step are
// recomputed from taut as K1 forms them.  The gates carry no gradient and
// are recomputed as K1 forms them: the cloudy layer (banded: cldfrac >=
// CLOUD_GATE, for every g; fused and cldf-odcld: any g-point with cldf >=
// 0.5), the g's gate (cldf >= 0.5; banded: the layer's), cldprmc's
// CLDMIN tests and zero water paths (fused), the clear twin's iclddn
// (from the highest cloudy layer) and anyc, the od branches.  At od =
// secd * taut = 0 the maximum of the plain version passes half the
// gradient, as torch.maximum does at a tie.  The cloud fraction enters a
// cloudy layer linearly, through cf (srctot atot - gs) and the cloudy
// absorptance ef = (1 - exp(-secd odcld)) cf.
//
// Bound on the H100: bytes.  Per (layer, g, column) the kernel reads taut
// and fracs twice, the radiance entering the layer and its clear twin,
// the per-g cloud inputs twice (fused, cldf-odcld: cldf where the layer
// is cloudy, the others where the g-point is), and writes ct_taut,
// ct_fracs twice (read-add in the down sweep) and the cloud inputs'
// cotangents once, twice in a cloudy layer (outside one they are zero).
// Each input read once and each output written once, the bytes are ~5.1
// GB at B=16384, L=60 banded (1.5 ms at 3.35 TB/s), ~1.1 GB more in
// cldf-odcld and ~2.3 GB more in fused; against that a few tens of flops
// and 1-3 expf per element and sweep.  The two sweeps move about 7.7-8.1
// GB in banded (taut and fracs read twice, the four radiances once,
// ct_taut and ct_fracs written, read back and written again), ~1.8 GB
// more in cldf-odcld and ~3.2 GB more in fused.  They are rows of the
// (L, 140, B) arrays cut into column tiles; a tile of 32 columns reads
// and writes whole 128-byte L2 lines of them.
//
// Design.  A block holds 32 columns (a lane each) and one of NGRP = 5
// groups of whole bands (g-points 0-21, 22-51, 52-75, 76-107, 108-139),
// so a tile's rows are 128 contiguous bytes while its rows of a step still
// fit a ring of two slots at two blocks per SM.  A block takes its group
// and tile from a ticket, drawn from a counter of the launch as it
// starts: so a block that waits on another block of its tile (below)
// waits on one that started before it, whatever order the blocks are
// dispatched in.  Tickets run group-major: the blocks running together
// take one group of neighbouring tiles, whose pieces of the same rows
// share DRAM pages (tile-major, a tile's five blocks together, measured
// ~1.5x slower: k6g_variants ``tilemajor``).  Warp y takes the group's
// g-points y, y + 8, ... (at most 4) and carries their cotangents in
// registers.
// - Staged rows: every reverse step's rows arrive in a ring of G_RING
//   slots in shared memory, one step ahead, by Hopper's bulk tensor
//   copies in boxes of 32 columns x 8 rows (tensor maps over (rows, B)):
//   taut, fracs, the radiance entering the layer and its clear twin, in
//   the down sweep the up sweep's ct_taut and ct_fracs of the layer and
//   its band-summed outputs, planklay and planklev of the group's bands,
//   the two flux cotangents, and where a column of the tile is cloudy at
//   the layer the mode's cloud rows (banded: cldfrac and taucb;
//   cldf-odcld: cldf, odcld; fused: cldf, ciwp, clwp, tauc, abi, abl).
//   Warp 0 arms the slot's mbarrier with the bytes and issues the
//   copies, a box a lane.  The consumers read only shared memory in the
//   g-loop.  A slot is reused once every thread has arrived on its
//   "empty" mbarrier after the step.  Where a row is not 16-byte aligned
//   (B not a multiple of 4, or an operand's start), every thread copies
//   its share of the elements by cp.async instead, completing the same
//   barriers.  The down sweep's first step is issued after the up sweep
//   (it reads the up sweep's last stores back), its second after the
//   surface step, which uses that slot's rows.
// - Band sums: the per-g values summed over a band's g-points (planklay,
//   planklev, the secant; banded: taucb; fused: abi, abl) are written
//   over the slot's rows they were computed from; after the step's one
//   block barrier, warp k sums band k of the group for its 32 columns in
//   ascending g (the first design's order: the same bits), the secant
//   into a running sum over both sweeps.
// - Banded's cloud fraction sums over all 140 g-points, across the
//   tile's groups: each group's last warp sums its g-points in ascending
//   order into a share of the layer (the up sweep's, then plus the down
//   sweep's), kept in shared memory while two blocks still fit an SM
//   (L <= 381), else in the launch's scratch; at the end the tile's five
//   blocks add their shares to the output in group order, each after the
//   one before it (the count of the tile; a lower group's ticket is
//   drawn first).  The first design summed K6 maxrand's lanes of two
//   bands each: this order is another, and the output differs from that
//   design's in the last bits (PERF.md).
// - The cloudy layers (a bit per column, a word per layer): banded each
//   block from cldfrac; the per-g modes read the words K1's gradient-step
//   launch wrote beside the radiances (rtrn_kernel.cuh, SAVE), so no
//   block forms them or waits for another's.
// - The per-g cloud cotangents outside a cloudy layer and in the pad
//   rows are zero: the up sweep writes the zeros (no arithmetic), the
//   down sweep adds only in a cloudy layer, to the up sweep's values
//   loaded in one batch after the g-loop.  (A zeroed allocation and no
//   zero stores measured slower on the H100, the fill included: the
//   k6g_variants ``fill`` variant, PERF.md.)
// No atomics on floats: two runs are bitwise equal.  Block barriers: one
// per step, three more around the surface step.
// - The d/dT adjoint (rt_bwd_g_ddt_kernel): the d/dT up sweep is linear
//   in the derivative P (rtrn.ddt_adjoint), so layer l's transmittances
//   get lam x P, lam the cotangent of the derivative leaving the layer
//   (top down) and P the derivative entering it (surface up).  K1's
//   gradient-step launch keeps P and its clear twin PC (rads planes
//   P_DDT, P_DDT + 1; rtrn_kernel.cuh, SAVE), so the whole d/dT adjoint
//   runs in the reverse up sweep: each thread carries lam and its clear
//   twin's of its g-points in registers, the step stages the group's P
//   and PC rows of the layer into the slot's PT and PF slabs (which the
//   up sweep does not read otherwise; PC's only where a column of the
//   tile has a cloud), and each thread reads its two cells before the
//   step writes over them.  The surface step sums the seed's cotangents
//   per band beside em and pb, over the slot's RAD rows; the down sweep
//   is the idrv=0 kernel's.  No scratch: carrying P in the down sweep
//   instead needs lam kept from the up sweep, 2 (L, 140, B) planes
//   written and read back, 2.2 GB at B=16384, L=60 beside the bound.
//   Two blocks per SM, as the idrv=0 kernel.
// - Compact's d/dT (on K1's 16 x 16 tile, where a thread carried 9
//   g-points, its d/dT carries took it to 192 registers and one block
//   per SM, 7.6x its bound): the step is
//   compact's (rtrn_bwd.cu step_bwd) through the fused branch, cf the
//   mask value, the water paths cw x cf, the cloud od only of cldprmc's
//   water (no input od).  A slot also holds, where a column of the tile
//   is cloudy at the layer, the group's int8 mask rows (boxes of 32 x 8
//   bytes: the bulk copies need B % 16 == 0, else every row goes element
//   by element, the mask's through registers, published by the block
//   barrier before their first read), the layer's two cw rows and abi,
//   abl as band blocks (fused's).  Its per-g cotangents of cw (a sum over
//   all 140 g-points) go over the slot's PF and RAD rows; the last warp
//   sums the group's, per band in ascending g, then over its bands in
//   band order, into the group's share of the layer (the up sweep's, then
//   plus the down sweep's), two floats a (layer, column), kept in shared
//   memory up to L = 153, else in the scratch; at the end the tile's five
//   blocks add their shares in group order, as banded's.  The up and down
//   sweeps' totals were summed apart before: the output differs in the
//   last bits.  The secant's cotangent is summed per (g, column) over
//   both sweeps in shared memory, then per band in ascending g, the order
//   of the 16 x 16 design.  The cloudy layers come from K1 SAVE compact's
//   words at idrv=1 (no pass over the mask).
//
// Shared memory a block (bytes):       banded   cldf-odcld      fused
//   ring slot                          31,104       37,120     49,408
//   ring of G_RING = 2 slots           62,208       74,240     98,816
//   the rest (GLayout) at L = 140      21,584        3,664      3,664
//   total at L = 140 (SMEM_BWD_G)      83,792       77,904    102,480
// Two blocks per SM: 2 x (102,496 + 1,024 reserved) <= 233,472, and so
// up to L = 3,444 in fused (the cloudy-layer words take 4 bytes a layer);
// banded's shares, 128 bytes a layer, stay in shared memory up to L = 381.
// Compact's d/dT: a slot 34,304 (its six slabs, the mask, cw and band
// rows), the ring 68,608, the rest 7,200 + 4 a layer with the per-g
// secants (4,096), its cw shares 256 a layer up to L = 153: at L = 140
// 112,208 (SMEM_BWD_G_COMPACT), two blocks per SM up to L = 9,976.
#include "bwd_groups.cuh"

namespace {

constexpr int NCLD = 6;                 // cloud inputs of a mode, at most

// rows of the saved radiances (rtrn_kernel.cuh SAVE)
// (and at idrv=1 the d/dT derivatives entering each layer, P_DDT on)
enum Saved { S_D = 0, S_U = 1, S_DC = 2, S_UC = 3, S_P = P_DDT,
             S_PC = P_DDT + 1 };

// the tensor maps of a launch: the per-g inputs, the radiances, the up
// sweep's ct_taut and ct_fracs, the band rows, the flux cotangents (one
// row a box), the up sweep's band-summed outputs (planklay, planklev;
// banded: taucb; fused, compact: abi, abl) and the mode's cloud inputs
// (Clouds order; banded's cldfrac one row a box; compact's mask bytes,
// its cw two rows a box); GH rows a box but where said
enum MapId { M_TAUT, M_FRACS, M_RADS, M_GTAUT, M_GFRACS, M_PLAY, M_PLEV,
             M_CT, M_GPLAY, M_GPLEV, M_GBC, M_GBC1, M_C0,
             NMAP = M_C0 + NCLD };
struct GMaps {
    CUtensorMap m[NMAP];
};

// Byte layout of one reverse step in the ring: (row, column) tiles of GX
// columns, a row RB bytes.  The per-g slabs hold the group's g-points
// (GBOX boxes of GH rows: up to GR rows, the last box reaching into the
// next group's); the band blocks GH rows from the group's first band.
// The step writes its per-g values to be summed over the bands over its
// TAU, FR, RAD (planklay, planklev, secant), RADC and PT rows (banded:
// taucb, cloud fraction; fused: abi, abl), and the down sweep's per-g
// cloud cotangents over its CLD rows, each thread over the elements it
// has read.  Compact: planklay, planklev, abi, abl, cw's two over TAU,
// FR, RADC, PT, PF and RAD.  At idrv=1 the up sweep stages the d/dT
// derivatives P and PC entering the layer in its PT and PF slabs.
template <int MODE>
struct GSlot {
    // per-g cloud input rows: cldf-odcld cldf, odcld; fused cldf, ciwp,
    // clwp, tauc; the band cloud rows: banded taucb; fused, compact abi,
    // abl
    static constexpr int NCG = MODE == FUSED ? 4 : MODE == CLDF_OD ? 2 : 0;
    static constexpr int NBC =
        MODE == FUSED || MODE == COMPACT ? 2 : MODE == BANDED ? 1 : 0;
    static constexpr int SLAB = GBOX * GH * RB;
    static constexpr int BAND = GH * RB;
    static constexpr int TAU = 0;
    static constexpr int FR = TAU + SLAB;
    static constexpr int RAD = FR + SLAB;
    static constexpr int RADC = RAD + SLAB;
    static constexpr int PT = RADC + SLAB;           // up sweep's ct_taut
    static constexpr int PF = PT + SLAB;             // and ct_fracs
    static constexpr int CLD = PF + SLAB;            // NCG slabs
    static constexpr int PLAY = CLD + NCG * SLAB;    // (GH, GX)
    static constexpr int PLEV = PLAY + BAND;
    static constexpr int BC = PLEV + BAND;           // NBC band blocks
    // the down sweep's partials of the band-summed outputs
    static constexpr int PPLAY = BC + NBC * BAND;
    static constexpr int PPLEV = PPLAY + BAND;
    static constexpr int PBC = PPLEV + BAND;         // NBC band blocks
    static constexpr int CT0 = PBC + NBC * BAND;     // UP or DOWN
    static constexpr int CT1 = CT0 + RB;             // CLR_UP or CLR_DOWN
    static constexpr int CF = CT1 + RB;              // banded: cldfrac
    static constexpr int CW = CF + (MODE == BANDED ? RB : 0);  // compact:
    static constexpr int MSK = CW + (MODE == COMPACT ? 2 * RB : 0);  // cw,
    // and the group's mask rows, a byte a column (GBOX boxes of GH rows)
    static constexpr int BYTES = MSK + (MODE == COMPACT ? GBOX * GH * GX : 0);
    static_assert(RB % 128 == 0 && BYTES % 128 == 0, "128-byte rows");
};

// The block's dynamic shared memory: the ring, the full and empty
// mbarriers of each slot, the block's ticket, the flux weight of every g, the first g of every band, the band
// (0-7 of the group) of each of the group's g-points, the bands' secants
// per column and the secant's cotangents, the highest cloudy layer of
// each column (these two held here, not in registers across the sweeps:
// K6 banded has none to spare), compact's secant cotangent of each of
// the group's (g, column), the cloudy-layer words (a bit per column, L),
// banded's shares of the cloud fraction's cotangent (compact: of cw's
// two) where they fit, and 128 bytes to align the ring.
template <int MODE>
struct GLayout {
    using S = GSlot<MODE>;
    static constexpr int BAR = G_RING * S::BYTES;
    static constexpr int TICKET = BAR + 2 * G_RING * 8;
    static constexpr int WG = TICKET + 8;                    // (KG)
    static constexpr int GOFF = WG + KG * 4;                 // (KNB + 1)
    static constexpr int RK = GOFF + (KNB + 1) * 4;          // (GR)
    static constexpr int SECD = align16(RK + GR * 4);        // (GNB, GX)
    static constexpr int CSEC = SECD + GNB * GX * 4;         // (GNB, GX)
    static constexpr int HI = CSEC + GNB * GX * 4;           // (GX)
    static constexpr int CSG = HI + GX * 4;                  // (GR, GX)
    static constexpr int FLAGS = CSG + (MODE == COMPACT ? GR * GX * 4 : 0);
    // the shares of a (layer, column): banded the cloud fraction's,
    // compact cw's two
    static constexpr int NSH = MODE == BANDED ? 1 : MODE == COMPACT ? 2 : 0;
    // the group's shares, (L, NSH, GX), here while two blocks still fit
    // an SM with them
    __host__ __device__ static constexpr int part(int L) {
        return FLAGS + (L * 4 + 15) / 16 * 16;
    }
    __host__ __device__ static constexpr bool shares_here(int L) {
        return NSH > 0
               && G_BLOCKS_PER_SM * (part(L) + L * NSH * GX * 4 + 128
                                     + SMEM_RESERVED) <= SMEM_SM;
    }
    __host__ __device__ static constexpr int bytes(int L) {
        return part(L) + (shares_here(L) ? L * NSH * GX * 4 : 0) + 128;
    }
};

// the budget of the header, at L = 140
constexpr int SMEM_BWD_G[3] = {83792, 77904, 102480};
static_assert(GLayout<BANDED>::bytes(140) == SMEM_BWD_G[0]
              && GLayout<CLDF_OD>::bytes(140) == SMEM_BWD_G[1]
              && GLayout<FUSED>::bytes(140) == SMEM_BWD_G[2],
              "K6-g's shared memory is the header's budget");
static_assert(G_BLOCKS_PER_SM * (SMEM_BWD_G[0] + SMEM_RESERVED) <= SMEM_SM
              && G_BLOCKS_PER_SM * (SMEM_BWD_G[2] + SMEM_RESERVED)
                     <= SMEM_SM,
              "two K6-g blocks fit an SM");
static_assert(GLayout<BANDED>::shares_here(381)
              && !GLayout<BANDED>::shares_here(382)
              && G_BLOCKS_PER_SM * (GLayout<FUSED>::bytes(3444)
                                    + SMEM_RESERVED) <= SMEM_SM,
              "banded's shares in shared memory up to L = 381; two fused "
              "blocks per SM up to L = 3,444");
// compact's d/dT at L = 140; its cw shares in shared memory up to L = 153
constexpr int SMEM_BWD_G_COMPACT = 112208;
static_assert(GLayout<COMPACT>::bytes(140) == SMEM_BWD_G_COMPACT
              && G_BLOCKS_PER_SM * (SMEM_BWD_G_COMPACT + SMEM_RESERVED)
                     <= SMEM_SM
              && GLayout<COMPACT>::shares_here(153)
              && !GLayout<COMPACT>::shares_here(154)
              && G_BLOCKS_PER_SM * (GLayout<COMPACT>::bytes(9976)
                                    + SMEM_RESERVED) <= SMEM_SM,
              "compact's cw shares in shared memory up to L = 153; two "
              "blocks per SM up to L = 9,976");
// The cloud inputs of each mode, in the order of rtrn_cuda.CLOUD_INPUTS:
// banded: c[0] cldfrac (L, B), c[1] taucb (L, 16, B); cldf-odcld: c[0]
// cldf, c[1] odcld (L, 144, B); fused: c[0..3] cldf, ciwp, clwp, tauc
// (L, 144, B), c[4], c[5] abi, abl (L, 16, B); compact: c[0] the mask
// (L, 144, B) int8, c[1] cw (L, 2, B), c[4], c[5] abi, abl as fused's
// (c[2], c[3] null).  The cotangents likewise (compact's mask: none).
struct Clouds {
    const float* c[NCLD];
};
struct GGrads {
    float* taut;     // (L, 140, B)
    float* fracs;    // (L, 140, B)
    float* play;     // (L, 16, B)
    float* plev;     // (L+1, 16, B)
    float* surf;     // (3, 16, B)
    float* c[NCLD];  // the cloud inputs' cotangents
};


// What a reverse step gives besides the carries: the cotangents of the
// g's taut and fracs, of its band's Planck rows at the layer (bl) and at
// the level bounding the step (pl), of the secant, of the cloud fraction
// (banded: this g's share of the layer's), of the cloud od (banded: the
// band's taucb; cldf-odcld: odcld; fused: tauc) and, fused and compact,
// of the water paths and the band's coefficients; compact: secc, the
// cloud's part of the secant's (secd the gas's), added in that order as
// rtrn_bwd.cu's step_bwd adds them.
struct StepGrads {
    float tau, fr, bl, pl, secd, cf, tauc, ciwp, clwp, abi, abl, secc;
};

// Reverse of one advance() of a layer for one (column, g), with K1's
// staged_step in MODE: tau, fr the g's taut and fracs, bl, pl the band's
// Planck rows, secd its secant; cf the cloud fraction (banded: the
// layer's; else the g's), tauc the cloud od (banded: the band's taucb;
// cldf-odcld: odcld; fused: tauc; compact: 0), ciwp, clwp the g's water
// paths (compact: cw x cf where the g's gate holds) and ai_b, al_b the
// band's coefficients (fused, compact); cly the layer's flag, twin
// the clear twin's; rad, radc the radiance and clear twin entering the
// layer.  lam, mu hold the cotangents of the step's outputs on entry and
// of its inputs on exit.  IDRV: dd carries the step of the d/dT sweep's
// adjoint (rtrn.cuh ddt_step_bwd), whose cotangents join the factors'
// (the reverse up sweep's steps).
template <int MODE, bool IDRV>
__device__ __forceinline__ StepGrads g_step_bwd(
        float tau, float fr, float bl, float pl, float secd, float cf,
        float tauc, float ciwp, float clwp, float ai_b, float al_b,
        bool cly, bool twin, float rad, float radc, float& lam, float& mu,
        DdtStep& dd) {
    // cldprmc's water paths (compact: its own, rtrn_bwd.cu step_bwd)
    constexpr bool CWP = MODE == FUSED || MODE == COMPACT;
    StepGrads o{};
    const float dp = pl - bl;
    const float x = secd * tau;
    const float od = fmaxf(x, 0.0f);
    float at, tfg, dat, dtfg;
    factors_d(od, od <= 0.06f, at, tfg, dat, dtfg);
    const float src = fr * (bl + tfg * dp);
    const float gs = at * src;

    // the cloud quantities of a cloudy layer (K1 staged_step)
    float ef = 0.0f, atot = at, srctot = src, datot = 0.0f, dtft = 0.0f,
          tft = tfg, ecl = 1.0f, odcld = 0.0f, ai = 0.0f, al = 0.0f;
    bool gate = false, active = false;
    if (cly) {
        gate = MODE == BANDED || cf >= 0.5f;
        if (gate) {
            odcld = tauc;
            if constexpr (CWP) {
                // cldprmc (rrtmg_lw_cldprmc.f90:128-142)
                ai = ciwp == 0.0f ? 0.0f : ai_b;
                al = clwp == 0.0f ? 0.0f : al_b;
                const float cwp = ciwp + clwp;
                active = cf >= CLDMIN && (cwp >= CLDMIN || tauc >= CLDMIN);
                if (active) odcld = ciwp * ai + clwp * al;
            }
        }
        const float odce = gate ? secd * odcld : 0.0f;
        ecl = expf(-odce);
        ef = gate ? (1.0f - ecl) * cf : 0.0f;
        const float xt = od + odce;
        factors_d(xt, xt < 0.06f, atot, tft, datot, dtft);
        srctot = fr * (bl + tft * dp);
    }

    // reverse of advance(): rn = cly ? rcld : rclr; radc' = twin ?
    // radc + (src - radc) at : rn
    const float ct_rn = lam + (twin ? 0.0f : mu);
    float ct_at = 0.0f, ct_src = 0.0f, ct_ef = 0.0f, ct_atot = 0.0f,
          ct_srctot = 0.0f, ct_radc = 0.0f, ct_rad;
    if (twin) {
        ct_src += mu * at;
        ct_at += mu * (src - radc);
        ct_radc = mu * (1.0f - at);
    }
    if (cly) {
        // rcld = rad - rad (at + ef (1 - at)) + gs + cf (srctot atot - gs)
        ct_rad = ct_rn * (1.0f - (at + ef * (1.0f - at)));
        ct_at += ct_rn * (src - rad * (1.0f - ef) - cf * src);
        ct_ef = -ct_rn * rad * (1.0f - at);
        ct_src += ct_rn * at * (1.0f - cf);
        ct_atot = ct_rn * cf * srctot;
        ct_srctot = ct_rn * cf * atot;
        o.cf = ct_rn * (srctot * atot - gs);
        if (gate) o.cf += ct_ef * (1.0f - ecl);
    } else {
        ct_rad = ct_rn * (1.0f - at);
        ct_src += ct_rn * at;
        ct_at += ct_rn * (src - rad);
    }
    lam = ct_rad;
    mu = ct_radc;
    if constexpr (IDRV)
        ddt_step_bwd(dd, at, atot, cf, cly, ct_at, ct_atot, o.cf);

    // factors -> inputs
    o.fr = ct_src * (bl + tfg * dp) + ct_srctot * (bl + tft * dp);
    const float ct_dp = fr * (ct_src * tfg + ct_srctot * tft);
    o.bl = fr * (ct_src + ct_srctot) - ct_dp;
    o.pl = ct_dp;
    float ct_od = ct_at * dat + ct_src * fr * dp * dtfg;
    if (cly) {
        const float ct_xt = ct_atot * datot + ct_srctot * fr * dp * dtft;
        ct_od += ct_xt;
        if (gate) {
            const float ct_odce = ct_xt + ct_ef * cf * ecl;
            if constexpr (MODE == COMPACT)
                o.secc = ct_odce * odcld;
            else
                o.secd += ct_odce * odcld;
            const float ct_odcld = ct_odce * secd;
            if (CWP && active) {
                o.ciwp = ct_odcld * ai;
                o.clwp = ct_odcld * al;
                o.abi = ciwp == 0.0f ? 0.0f : ct_odcld * ciwp;
                o.abl = clwp == 0.0f ? 0.0f : ct_odcld * clwp;
            } else {
                o.tauc = ct_odcld;
            }
        }
    }
    const float ct_x = x > 0.0f ? ct_od : (x == 0.0f ? 0.5f * ct_od : 0.0f);
    o.tau = ct_x * secd;
    o.secd += ct_x * tau;
    return o;
}

// The scratch of a launch (GScratch, bwd_groups.cuh): the counter the
// tickets are drawn from, then (banded) one a column tile (zeroed: the
// groups' turn to add their shares of the cloud fraction's cotangent);
// banded's (compact's) shares where they do not fit shared memory
// ((blocks, L, NSH, GX), else null).  The per-g modes' cloudy-layer
// words ((tiles, L), K1's) in its words.

// The kernel's body; IDRV: with the d/dT sweep's adjoint (dt), its
// cotangents of each layer's factors added to the up sweep's reverse
// step of the layer, from the derivatives K1 kept (rads planes S_P,
// S_PC).  maps: the kernel's __grid_constant__ parameter.
template <int MODE, bool IDRV>
__device__ __forceinline__ void rt_bwd_g_body(
        const GMaps& maps, const Inputs& in, const Clouds& cl,
        const int* __restrict__ ngb, const float* __restrict__ wg,
        const float* __restrict__ ct, const float* __restrict__ rads,
        const GGrads& gr, const GScratch& sc, int vec, const Ddt& dt) {
    using Sl = GSlot<MODE>;
    using Lo = GLayout<MODE>;
    constexpr bool BND = MODE == BANDED;
    constexpr bool FSD = MODE == FUSED;
    constexpr bool CMP = MODE == COMPACT;
    constexpr bool ABL = FSD || CMP;        // band rows abi, abl
    constexpr int NCG = Sl::NCG;
    constexpr int NBC = Sl::NBC;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // the ring at a 128-byte boundary
    unsigned char* smem =
        smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lo::BAR);
    uint64_t* empty = full + G_RING;
    float* wg_s = reinterpret_cast<float*>(smem + Lo::WG);
    int* goff = reinterpret_cast<int*>(smem + Lo::GOFF);
    int* rk = reinterpret_cast<int*>(smem + Lo::RK);
    float* secd_s = reinterpret_cast<float*>(smem + Lo::SECD);
    float* csec_s = reinterpret_cast<float*>(smem + Lo::CSEC);
    int* hi_s = reinterpret_cast<int*>(smem + Lo::HI);
    float* csg = reinterpret_cast<float*>(smem + Lo::CSG);
    unsigned* flags = reinterpret_cast<unsigned*>(smem + Lo::FLAGS);
    int* ticket = reinterpret_cast<int*>(smem + Lo::TICKET);
    int* tcount = sc.count + 1;             // the tiles' counters
    const int tid = threadIdx.x;
    const int tx = tid % GX, ty = tid / GX;
    const int L = in.L, B = in.B;
    const size_t Bz = B;

    // ---- 0. the block's ticket, then its group: bands b0 .. b0 + nb - 1,
    // g-points g0 .. g0+nr-1
    for (int i = tid; i < KG; i += GT) {
        wg_s[i] = wg[i];
        if (i == 0 || ngb[i] != ngb[i - 1]) goff[ngb[i]] = i;
    }
    if (tid == 0) {
        *ticket = atomicAdd(sc.count, 1);
        goff[KNB] = KG;
        for (int i = 0; i < G_RING; ++i) {
            mbar_init(&full[i], vec ? 1u : (unsigned)GT);
            mbar_init(&empty[i], (unsigned)GT);
        }
        fence_mbarrier_init();
    }
    __syncthreads();
    // group-major: the blocks running together take one group of
    // neighbouring tiles, so that they read the same rows' neighbouring
    // pieces (DRAM pages)
    const int tk = *ticket;
    const int ntiles = gridDim.x / NGRP;
    const int grp = tk / ntiles, tile = tk % ntiles;
    const int bt = tile * GX;
    const int nvalid = min(GX, B - bt);
    // lanes past the ragged edge compute on what their slot holds and
    // write nothing; they take part in the staging and the barriers
    const bool valid = tx < nvalid;
    const int b = bt + tx;
    // banded: the block's share of the cloud fraction's cotangent of
    // layer l, column tx (compact: of cw's first, its second GX floats
    // on; the block's (L, NSH, GX) in shared memory or in the scratch,
    // formed where it is used)
    constexpr int NSH = Lo::NSH;
    auto share = [&](int l) {
        float* p = sc.part ? sc.part + (size_t)tk * L * NSH * GX
                           : reinterpret_cast<float*>(smem + Lo::part(L));
        return p + l * NSH * GX + tx;
    };
    const int b0 = GFIRST[grp], nb = GFIRST[grp + 1] - b0;
    const int g0 = goff[b0], nr = goff[b0 + nb] - g0;
    for (int k = 0; k < nb; ++k)
        for (int r = goff[b0 + k] - g0 + tid; r < goff[b0 + k + 1] - g0;
             r += GT)
            rk[r] = k;
    if (ty < nb) {
        secd_s[tid] = in.surf[(size_t)(b0 + ty) * Bz + bt
                              + min(tx, nvalid - 1)];
        csec_s[tid] = 0.0f;     // warp ty's band, column tx
    }

    // ---- 1. the cloudy layers: a bit per column, a word per layer.
    // Banded: from cldfrac.  The per-g modes: the tile's words, which
    // K1 wrote ----
    if constexpr (BND) {
        for (int l = ty; l < L; l += GY) {
            const bool c = valid && cl.c[0][(size_t)l * Bz + b] >= CLOUD_GATE;
            const unsigned w = __ballot_sync(0xffffffffu, c);
            if (tx == 0) flags[l] = w;
        }
    } else {
        for (int i = tid; i < L; i += GT)
            flags[i] = sc.words[(size_t)tile * L + i];
    }
    __syncthreads();
    int hi = -1;                            // the highest cloudy layer
    for (int l = L - 1; l >= 0 && hi < 0; --l)
        if ((flags[l] >> tx) & 1u) hi = l;
    if (ty == 0) hi_s[tx] = hi;
    // IDRV: a column of the tile has a cloud (PC is staged only then)
    [[maybe_unused]] bool tcloud = false;
    if constexpr (IDRV)
        tcloud = __syncthreads_or(hi >= 0);
    else
        __syncthreads();
    auto slot = [&](int j) { return smem + (j % G_RING) * Sl::BYTES; };

    // ---- the staging of reverse step j: up sweep j < L, layer L-1-j,
    // Planck level l+1, flux rows UP, CLR_UP at level l+1, the up
    // radiance entering l (IDRV: and the d/dT derivatives entering l, P
    // and, where a column of the tile has a cloud, PC); down sweep j >= L,
    // layer j-L, Planck level l,
    // rows DOWN, CLR_DOWN at level l, the down radiance at level l+1 and
    // the up sweep's outputs of layer l.  The producer first waits until
    // every thread has left the slot's previous step. ----
    const size_t LGB = (size_t)L * KG * Bz;
    const int nbox = (nr + GH - 1) / GH;
    auto issue = [&](int j) {
        const bool up = j < L;
        const int l = up ? L - 1 - j : j - L;
        const int lev = up ? l + 1 : l;
        const bool has_in = up || l + 1 < L;
        const bool tc = flags[l] != 0u;
        unsigned char* d = slot(j);
        uint64_t* bar = &full[j % G_RING];
        const int rin = up ? l : l + 1;     // the radiances' layer
        const int ct0 = (up ? UP : DOWN) * (L + 1) + lev;
        const int ct1 = (up ? CLR_UP : CLR_DOWN) * (L + 1) + lev;
        const int nslab = 2 + (has_in ? 2 : 0) + (up ? 0 : 2)
                          + (tc ? NCG : 0)
                          + (IDRV && up ? (tcloud ? 2 : 1) : 0);
        const int nband = 2 + (tc ? NBC : 0)
                          + (up ? 0 : 1 + (lev > 0) + (tc ? NBC : 0));
        const int none = tc && BND ? 3 : 2;
        // compact, a cloudy tile: the mask rows' bytes and cw's two rows
        const int extra = CMP && tc ? nbox * GH * GX + 2 * RB : 0;
        if (vec) {
            // warp 0: a box a lane
            if (ty != 0) return;
            if (j >= G_RING)
                mbar_wait(&empty[j % G_RING], (unsigned)(j / G_RING - 1) & 1u);
            if (tx == 0)
                mbar_arrive_expect_tx(
                    bar, (uint32_t)(((nslab * nbox + nband) * GH + none)
                                    * RB + extra));
            __syncwarp();
        } else if (j >= G_RING) {
            // every thread copies its share of the valid columns' elements
            mbar_wait(&empty[j % G_RING], (unsigned)(j / G_RING - 1) & 1u);
        }
        // n rows of src from row0 at offset off: boxes of h rows (the
        // bulk copies), or the n rows element by element
        auto copy = [&](int off, int map, const float* src, int row0, int n,
                        int h) {
            if (vec) {
                for (int i = tx; i * h < n; i += GX)
                    tma_load_2d(d + off + i * h * RB, &maps.m[map], bt,
                                row0 + i * h, bar);
            } else {
                for (int i = tid; i < n * nvalid; i += GT) {
                    const int r = i / nvalid, c = i - r * nvalid;
                    cp4(d + off + r * RB + c * 4,
                        src + (size_t)(row0 + r) * Bz + bt + c);
                }
            }
        };
        // the group's g-points of a layer (row0 its g = 0), its bands (row0
        // its band 0), one row
        auto slab = [&](int off, int map, const float* src, int row0) {
            copy(off, map, src, row0 + g0, nr, GH);
        };
        auto bands = [&](int off, int map, const float* src, int row0) {
            copy(off, map, src, row0 + b0, vec ? GH : nb, GH);
        };
        auto one = [&](int off, int map, const float* src, int row) {
            copy(off, map, src, row, 1, 1);
        };
        slab(Sl::TAU, M_TAUT, in.taut, l * KG);
        slab(Sl::FR, M_FRACS, in.fracs, l * KG);
        if (has_in) {
            slab(Sl::RAD, M_RADS, rads, ((up ? S_U : S_D) * L + rin) * KG);
            slab(Sl::RADC, M_RADS, rads,
                 ((up ? S_UC : S_DC) * L + rin) * KG);
        }
        if (!up) {
            slab(Sl::PT, M_GTAUT, gr.taut, l * KG);
            slab(Sl::PF, M_GFRACS, gr.fracs, l * KG);
        }
        if constexpr (IDRV) {
            if (up) {
                slab(Sl::PT, M_RADS, rads, (S_P * L + l) * KG);
                if (tcloud) slab(Sl::PF, M_RADS, rads, (S_PC * L + l) * KG);
            }
        }
        if (tc)
            for (int q = 0; q < NCG; ++q)
                slab(Sl::CLD + q * Sl::SLAB, M_C0 + q, cl.c[q],
                     l * rrtm::NGPT_PAD);
        bands(Sl::PLAY, M_PLAY, in.play, l * KNB);
        bands(Sl::PLEV, M_PLEV, in.plev, lev * KNB);
        if (tc && BND) bands(Sl::BC, M_C0 + 1, cl.c[1], l * KNB);
        if (tc && (FSD || CMP)) {
            bands(Sl::BC, M_C0 + 4, cl.c[4], l * KNB);
            bands(Sl::BC + Sl::BAND, M_C0 + 5, cl.c[5], l * KNB);
        }
        if (!up) {
            bands(Sl::PPLAY, M_GPLAY, gr.play, l * KNB);
            if (lev > 0) bands(Sl::PPLEV, M_GPLEV, gr.plev, lev * KNB);
            if (tc && BND) bands(Sl::PBC, M_GBC, gr.c[1], l * KNB);
            if (tc && (FSD || CMP)) {
                bands(Sl::PBC, M_GBC, gr.c[4], l * KNB);
                bands(Sl::PBC + Sl::BAND, M_GBC1, gr.c[5], l * KNB);
            }
        }
        one(Sl::CT0, M_CT, ct, ct0);
        one(Sl::CT1, M_CT, ct, ct1);
        if (tc && BND) one(Sl::CF, M_C0, cl.c[0], l);
        if (CMP && tc) {
            copy(Sl::CW, M_C0 + 1, cl.c[1], 2 * l, 2, 2);
            // the group's mask rows: boxes of GX x GH bytes, or byte by
            // byte through registers (no cp.async takes one byte; the
            // block barrier before the step's first read publishes them)
            const int row0 = l * rrtm::NGPT_PAD + g0;
            if (vec) {
                for (int i = tx; i * GH < nr; i += GX)
                    tma_load_2d(d + Sl::MSK + i * GH * GX, &maps.m[M_C0], bt,
                                row0 + i * GH, bar);
            } else {
                const auto* m =
                    reinterpret_cast<const unsigned char*>(cl.c[0]);
                for (int i = tid; i < nr * nvalid; i += GT) {
                    const int r = i / nvalid, c = i - r * nvalid;
                    d[Sl::MSK + r * GX + c] =
                        m[(size_t)(row0 + r) * Bz + bt + c];
                }
            }
        }
        if (!vec) mbar_arrive_copies(bar);
    };

    float lam[GPT], mu[GPT], ct_fr0[GPT];
    // IDRV: the d/dT sweep's carries of each g-point, the cotangents of
    // the derivative and its clear twin in the reverse up sweep
    // (rtrn.ddt_adjoint's lam, lamc)
    constexpr int ND = IDRV ? GPT : 1;
    [[maybe_unused]] float dd[ND], ddc[ND];
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
        lam[k] = mu[k] = ct_fr0[k] = 0.0f;
        if constexpr (IDRV) dd[k] = ddc[k] = 0.0f;
        if constexpr (CMP)
            if (ty + GY * k < nr) csg[(ty + GY * k) * GX + tx] = 0.0f;
    }

    // out = v (up sweep) or pv + v (down sweep)
    auto out = [](float* p, float pv, float v, bool add) {
        *p = add ? pv + v : v;
    };

    // ---- 2. one reverse step j; FIRST: the first of the down sweep
    // (layer 0), which adds the surface's fracs cotangent ----
    auto step = [&](auto upward, auto first, int j) {
        constexpr bool UPW = decltype(upward)::value;
        constexpr bool FIRST = decltype(first)::value;
        const int l = UPW ? L - 1 - j : j - L;
        const int lev = UPW ? l + 1 : l;
        unsigned char* s = slot(j);
        auto row = [&](int off) { return reinterpret_cast<float*>(s + off); };
        float *tau_s = row(Sl::TAU), *fr_s = row(Sl::FR),
              *rad_s = row(Sl::RAD), *radc_s = row(Sl::RADC),
              *pt_s = row(Sl::PT), *pf_s = row(Sl::PF),
              *cld_s = row(Sl::CLD);
        const float *play_s = row(Sl::PLAY), *plev_s = row(Sl::PLEV),
                    *bc_s = row(Sl::BC);
        mbar_wait(&full[j % G_RING], (unsigned)(j / G_RING) & 1u);
        const bool cly = (flags[l] >> tx) & 1u;
        const bool twin = UPW ? hi_s[tx] >= 0 : l <= hi_s[tx];
        const bool has_in = UPW || l + 1 < L;
        const float cu = row(Sl::CT0)[tx], ccu = row(Sl::CT1)[tx];
        const float cfl = BND && cly ? row(Sl::CF)[tx] : 0.0f;
        // compact: the layer's water paths, and the mask rows
        const float cw0 = CMP && cly ? row(Sl::CW)[tx] : 0.0f;
        const float cw1 = CMP && cly ? row(Sl::CW)[GX + tx] : 0.0f;
        const auto* msk_s = reinterpret_cast<const int8_t*>(s + Sl::MSK);
        // idrv: the up sweep's d/dT cotangents at level lev
        constexpr bool DDT = IDRV && UPW;
        [[maybe_unused]] const bool anyc = hi_s[tx] >= 0;
        [[maybe_unused]] float cd = 0.0f, ccd = 0.0f;
        if constexpr (DDT) {
            if (valid) {
                cd = dt.ct[(size_t)lev * Bz + b];
                ccd = dt.ct[((size_t)(L + 1) + lev) * Bz + b];
            }
        }
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int r = ty + GY * k;
            if (r >= nr) continue;
            const int g = g0 + r;
            const int e = r * GX + tx, be = rk[r] * GX + tx;
            float lk = lam[k] + wg_s[g] * cu;
            float mk = mu[k] + wg_s[g] * ccu;
            const float rad = has_in ? rad_s[e] : 0.0f;
            const float radc = has_in ? radc_s[e] : 0.0f;
            float pt = 0.0f, pf = 0.0f;
            if constexpr (!UPW) {
                pt = pt_s[e];
                pf = pf_s[e];
            }
            // the cloud inputs, read where the step uses them
            float cf = cfl, tauc = 0.0f, ciwp = 0.0f, clwp = 0.0f,
                  ai_b = 0.0f, al_b = 0.0f;
            if (cly) {
                if constexpr (BND) {
                    tauc = bc_s[be];
                } else if constexpr (CMP) {
                    cf = (float)msk_s[e];
                    if (cf >= 0.5f) {
                        ciwp = cw0 * cf;
                        clwp = cw1 * cf;
                    }
                } else {
                    cf = cld_s[e];
                    if (cf >= 0.5f) {
                        if constexpr (FSD) {
                            ciwp = cld_s[Sl::SLAB / 4 + e];
                            clwp = cld_s[2 * Sl::SLAB / 4 + e];
                            tauc = cld_s[3 * Sl::SLAB / 4 + e];
                        } else {
                            tauc = cld_s[Sl::SLAB / 4 + e];
                        }
                    }
                }
                if constexpr (ABL) {
                    ai_b = bc_s[be];
                    al_b = bc_s[Sl::BAND / 4 + be];
                }
            }
            // idrv, up: the cotangent of the derivative leaving layer l
            // (the clear twin's folded in where it is the same) times the
            // derivatives entering it, K1's P and PC staged in this thread's
            // PT and PF cells (read before the step writes over them; PC
            // selected, not multiplied, where the column has no cloud: the
            // cell is then not staged), the cotangents of the layer's
            // transmittances
            [[maybe_unused]] DdtStep ds{};
            [[maybe_unused]] float lt = 0.0f;
            if constexpr (DDT) {
                dd[k] += wg_s[g] * cd;
                ddc[k] += wg_s[g] * ccd;
                lt = anyc ? dd[k] : dd[k] + ddc[k];
                ds.ct_t = lt * pt_s[e];
                ds.ct_tc = anyc ? ddc[k] * pf_s[e] : 0.0f;
            }
            const StepGrads o = g_step_bwd<MODE, DDT>(
                tau_s[e], fr_s[e], play_s[be], plev_s[be], secd_s[be], cf,
                tauc, ciwp, clwp, ai_b, al_b, cly, twin, rad, radc, lk, mk,
                ds);
            lam[k] = lk;
            mu[k] = mk;
            if constexpr (DDT) {
                dd[k] = lt * ds.t;
                ddc[k] = anyc ? ddc[k] * ds.tc : 0.0f;
            }
            if (valid) {
                const size_t gi = ((size_t)l * KG + g) * Bz + b;
                if constexpr (UPW) {
                    gr.taut[gi] = o.tau;
                    gr.fracs[gi] = o.fr;
                } else {
                    gr.taut[gi] = pt + o.tau;
                    gr.fracs[gi] = (FIRST ? pf + ct_fr0[k] : pf) + o.fr;
                }
            }
            // the per-g values summed over the bands, over the rows read
            tau_s[e] = o.bl;
            fr_s[e] = o.pl;
            if constexpr (CMP) {
                // the secant's over both sweeps, per (g, column); cw's
                csg[e] = (csg[e] + o.secc) + o.secd;
                radc_s[e] = o.abi;
                pt_s[e] = o.abl;
                pf_s[e] = o.ciwp * cf;
                rad_s[e] = o.clwp * cf;
            } else {
                rad_s[e] = o.secd;
            }
            if constexpr (BND) {
                radc_s[e] = o.tauc;
                pt_s[e] = o.cf;
            }
            if constexpr (FSD) {
                radc_s[e] = o.abi;
                pt_s[e] = o.abl;
            }
            // the per-g cloud cotangents, nonzero only in a cloudy layer:
            // the up sweep stores them, the down sweep keeps them for the
            // add below
            if constexpr (NCG > 0) {
                if (cly) {
                    float v[NCG > 0 ? NCG : 1];
                    v[0] = o.cf;
                    if constexpr (FSD) {
                        v[1] = o.ciwp;
                        v[2] = o.clwp;
                        v[3] = o.tauc;
                    } else {
                        v[1] = o.tauc;
                    }
                    const size_t pi =
                        ((size_t)l * rrtm::NGPT_PAD + g) * Bz + b;
#pragma unroll
                    for (int q = 0; q < NCG; ++q) {
                        if constexpr (UPW) {
                            if (valid) gr.c[q][pi] = v[q];
                        } else {
                            cld_s[q * Sl::SLAB / 4 + e] = v[q];
                        }
                    }
                }
            }
        }
        // the per-g cloud cotangents' zeros outside the cloudy columns
        // and in the pad rows, written by the up sweep (a warp store a
        // 128-byte row)
        if constexpr (UPW && NCG > 0) {
            for (int r = ty; r < nr; r += GY)
                if (valid && !cly)
#pragma unroll
                    for (int q = 0; q < NCG; ++q)
                        gr.c[q][((size_t)l * rrtm::NGPT_PAD + g0 + r) * Bz
                                + b] = 0.0f;
            if (grp == NGRP - 1 && ty < rrtm::NGPT_PAD - KG && valid)
#pragma unroll
                for (int q = 0; q < NCG; ++q)
                    gr.c[q][((size_t)l * rrtm::NGPT_PAD + KG + ty) * Bz
                            + b] = 0.0f;
        }
        __syncthreads();          // the per-g values published

        // ---- the band sums: warp k, band b0 + k, in ascending g; the
        // down sweep adds them to the up sweep's, staged in the slot ----
        if (ty < nb) {
            float s_bl = 0.0f, s_pl = 0.0f, ct_sec = csec_s[tid];
            [[maybe_unused]] float s_c0 = 0.0f, s_c1 = 0.0f;
#pragma unroll 4
            for (int r = goff[b0 + ty] - g0; r < goff[b0 + ty + 1] - g0;
                 ++r) {
                const int e = r * GX + tx;
                s_bl += tau_s[e];
                s_pl += fr_s[e];
                if constexpr (!CMP) ct_sec += rad_s[e];
                if constexpr (BND || ABL) s_c0 += radc_s[e];
                if constexpr (ABL) s_c1 += pt_s[e];
            }
            if constexpr (!CMP) csec_s[tid] = ct_sec;
            const int be = ty * GX + tx;
            const size_t bi = ((size_t)l * KNB + b0 + ty) * Bz + b;
            const size_t vi = ((size_t)lev * KNB + b0 + ty) * Bz + b;
            if (valid) {
                out(gr.play + bi, UPW ? 0.0f : row(Sl::PPLAY)[be], s_bl,
                    !UPW);
                out(gr.plev + vi, UPW || lev == 0 ? 0.0f
                                                  : row(Sl::PPLEV)[be],
                    s_pl, !UPW && lev > 0);
                // the cloud inputs' cotangents are zero outside a cloudy
                // layer: the up sweep writes them, the down sweep adds
                // only in a cloudy one
                if (UPW || cly) {
                    if constexpr (BND || ABL)
                        out(gr.c[BND ? 1 : 4] + bi,
                            UPW ? 0.0f : row(Sl::PBC)[be], s_c0, !UPW);
                    if constexpr (ABL)
                        out(gr.c[5] + bi,
                            UPW ? 0.0f : row(Sl::PBC + Sl::BAND)[be], s_c1,
                            !UPW);
                }
            }
        }
        if constexpr (BND) {
            // the group's share of the cloud fraction's cotangent of
            // layer l, its g-points in ascending order (the last warp):
            // the up sweep's, then plus the down sweep's
            if (ty == GY - 1 && valid) {
                float p = 0.0f;
#pragma unroll 4
                for (int r = 0; r < nr; ++r) p += pt_s[r * GX + tx];
                float* q = share(l);
                *q = UPW ? p : *q + p;
            }
        }
        if constexpr (CMP) {
            // the group's share of cw's two cotangents of layer l (the
            // last warp): per band in ascending g, then over its bands in
            // band order; the up sweep's, then plus the down sweep's; zero
            // outside a cloudy layer
            if (ty == GY - 1 && valid) {
                float a0 = 0.0f, a1 = 0.0f;
                if (cly) {
                    for (int k = 0; k < nb; ++k) {
                        float s0 = 0.0f, s1 = 0.0f;
                        for (int r = goff[b0 + k] - g0;
                             r < goff[b0 + k + 1] - g0; ++r) {
                            s0 += pf_s[r * GX + tx];
                            s1 += rad_s[r * GX + tx];
                        }
                        a0 += s0;
                        a1 += s1;
                    }
                }
                float* q = share(l);
                if (UPW) {
                    q[0] = a0;
                    q[GX] = a1;
                } else if (cly) {
                    q[0] += a0;
                    q[GX] += a1;
                }
            }
        }
        // the down sweep adds the up sweep's per-g cloud cotangents of a
        // cloudy layer, loaded in one batch
        if constexpr (!UPW && NCG > 0) {
            if (cly && valid) {
                float cpart[NCG][GPT];
#pragma unroll
                for (int q = 0; q < NCG; ++q)
#pragma unroll
                    for (int k = 0; k < GPT; ++k) {
                        const int r = ty + GY * k;
                        if (r < nr)
                            cpart[q][k] = gr.c[q][((size_t)l * rrtm::NGPT_PAD
                                                   + g0 + r) * Bz + b];
                    }
#pragma unroll
                for (int q = 0; q < NCG; ++q)
#pragma unroll
                    for (int k = 0; k < GPT; ++k) {
                        const int r = ty + GY * k;
                        if (r < nr)
                            gr.c[q][((size_t)l * rrtm::NGPT_PAD + g0 + r)
                                    * Bz + b] =
                                cpart[q][k]
                                + cld_s[q * Sl::SLAB / 4 + r * GX + tx];
                    }
            }
        }
        // the slot is free once every thread has arrived
        fence_proxy_async_smem();
        mbar_arrive(&empty[j % G_RING]);
    };

    issue(0);
    if (1 < L) issue(1);
    // compact: the mask rows its element copies stored through registers
    if constexpr (CMP) __syncthreads();

    // ---- 3. up sweep in reverse: layer L-1 .. 0 ----
    for (int j = 0; j < L; ++j) {
        step(std::true_type{}, std::false_type{}, j);
        if (j + 2 < L) issue(j + 2);
    }

    // ---- 4. surface reflection in reverse; the down sweep's first step
    // reads the up sweep's last stores back, so it is issued after them,
    // and its second into the slot whose rows the surface step uses ----
    fence_proxy_async_global();
    __syncthreads();
    issue(L);
    {
        float* em = reinterpret_cast<float*>(slot(L + 1) + Sl::TAU);
        float* pb = reinterpret_cast<float*>(slot(L + 1) + Sl::FR);
        // idrv: the per-g shares of the cotangent of dplankbnd_dt
        [[maybe_unused]] float* dz =
            reinterpret_cast<float*>(slot(L + 1) + Sl::RAD);
        const float cu = valid ? ct[(size_t)UP * (L + 1) * Bz + b] : 0.0f;
        const float ccu =
            valid ? ct[(size_t)CLR_UP * (L + 1) * Bz + b] : 0.0f;
        [[maybe_unused]] float cd0 = 0.0f, ccd0 = 0.0f;
        if constexpr (IDRV) {
            if (valid) {
                cd0 = dt.ct[b];
                ccd0 = dt.ct[(size_t)(L + 1) * Bz + b];
            }
        }
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int r = ty + GY * k;
            if (r >= nr) continue;
            const int g = g0 + r, bd = b0 + rk[r];
            const size_t gi = (size_t)g * Bz + b;
            const float lam0 = lam[k] + wg_s[g] * cu;
            const float mu0 = mu[k] + wg_s[g] * ccu;
            float pbnd = 0.0f, reflect = 0.0f, d0 = 0.0f, dc0 = 0.0f,
                  fr0 = 0.0f;
            if (valid) {
                pbnd = in.surf[((size_t)2 * KNB + bd) * Bz + b];
                reflect = 1.0f - in.surf[((size_t)KNB + bd) * Bz + b];
                d0 = rads[S_D * LGB + gi];
                dc0 = rads[S_DC * LGB + gi];
                fr0 = in.fracs[gi];
            }
            const float ct_rad0 = lam0 + mu0;
            ct_fr0[k] = ct_rad0 * pbnd;
            em[r * GX + tx] = -(lam0 * d0 + mu0 * dc0);
            pb[r * GX + tx] = ct_rad0 * fr0;
            lam[k] = lam0 * reflect;
            mu[k] = mu0 * reflect;
            if constexpr (IDRV) {
                // the d/dT seed fracs[0] x dplankbnd_dt takes the
                // cotangent of both derivatives at the surface
                const float dpl =
                    valid ? in.surf[((size_t)3 * KNB + bd) * Bz + b] : 0.0f;
                const float ctd0 = dd[k] + wg_s[g] * cd0
                                   + (ddc[k] + wg_s[g] * ccd0);
                ct_fr0[k] += ctd0 * dpl;
                dz[r * GX + tx] = ctd0 * fr0;
            }
        }
        fence_proxy_async_smem();
        __syncthreads();
        if (ty < nb && valid) {
            float s_em = 0.0f, s_pb = 0.0f;
            [[maybe_unused]] float s_dz = 0.0f;
            for (int r = goff[b0 + ty] - g0; r < goff[b0 + ty + 1] - g0;
                 ++r) {
                s_em += em[r * GX + tx];
                s_pb += pb[r * GX + tx];
                if constexpr (IDRV) s_dz += dz[r * GX + tx];
            }
            gr.surf[((size_t)KNB + b0 + ty) * Bz + b] = s_em;
            gr.surf[((size_t)2 * KNB + b0 + ty) * Bz + b] = s_pb;
            if constexpr (IDRV)
                gr.surf[((size_t)3 * KNB + b0 + ty) * Bz + b] = s_dz;
        }
        __syncthreads();
    }
    if (L + 1 < 2 * L) issue(L + 1);

    // ---- 5. down sweep in reverse: layer 0 .. L-1 ----
    step(std::false_type{}, std::true_type{}, L);
    if (L + 2 < 2 * L) issue(L + 2);
    for (int j = L + 1; j < 2 * L; ++j) {
        step(std::false_type{}, std::false_type{}, j);
        if (j + 2 < 2 * L) issue(j + 2);
    }

    // ---- 6. the secants, summed over both sweeps (compact: each g's,
    // then per band in ascending g) ----
    if (ty < nb && valid) {
        float cs = csec_s[tid];
        if constexpr (CMP) {
            cs = 0.0f;
            for (int r = goff[b0 + ty] - g0; r < goff[b0 + ty + 1] - g0; ++r)
                cs += csg[r * GX + tx];
        }
        gr.surf[(size_t)(b0 + ty) * Bz + b] = cs;
    }

    // ---- 7. banded (compact): the tile's groups add their shares of the
    // cloud fraction's (cw's) cotangent in group order, each after the one
    // before it (whose ticket was drawn first) ----
    if constexpr (BND || CMP) {
        if (tid == 0) {
            while (atomicAdd(&tcount[tile], 0) != grp) __nanosleep(256);
            __threadfence();
        }
        __syncthreads();
        for (int l = ty; l < L; l += GY) {
            if (!valid) continue;
#pragma unroll
            for (int q = 0; q < NSH; ++q) {
                float* p = gr.c[BND ? 0 : 1] + ((size_t)l * NSH + q) * Bz + b;
                const float v = share(l)[q * GX];
                *p = grp == 0 ? v : __ldcg(p) + v;
            }
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) atomicExch(&tcount[tile], grp + 1);
    }
}

template <int MODE>
__global__ void __launch_bounds__(GT, G_BLOCKS_PER_SM)
rt_bwd_g_kernel(__grid_constant__ const GMaps maps, Inputs in, Clouds cl,
                const int* __restrict__ ngb, const float* __restrict__ wg,
                const float* __restrict__ ct, const float* __restrict__ rads,
                GGrads gr, GScratch sc, int vec) {
    rt_bwd_g_body<MODE, false>(maps, in, cl, ngb, wg, ct, rads, gr, sc, vec,
                               Ddt{});
}

// K6-g with the d/dT sweep's adjoint (idrv=1 and a cotangent of duflx_dt
// or duflxc_dt), two blocks per SM as the idrv=0 kernel.
template <int MODE>
__global__ void __launch_bounds__(GT, G_BLOCKS_PER_SM)
rt_bwd_g_ddt_kernel(__grid_constant__ const GMaps maps, Inputs in,
                    Clouds cl, const int* __restrict__ ngb,
                    const float* __restrict__ wg,
                    const float* __restrict__ ct,
                    const float* __restrict__ rads, GGrads gr, GScratch sc,
                    int vec, Ddt dt) {
    rt_bwd_g_body<MODE, true>(maps, in, cl, ngb, wg, ct, rads, gr, sc, vec,
                              dt);
}

template <int MODE, bool IDRV>
auto bwd_g_kernel() {
    if constexpr (IDRV)
        return rt_bwd_g_ddt_kernel<MODE>;
    else
        return rt_bwd_g_kernel<MODE>;
}

// the shared memory attributes of an instantiation, set once per process
// (at the largest dynamic shared memory a block can take: it grows with L)
template <int MODE, bool IDRV = false>
cudaError_t prepare_bwd_g() {
    static const cudaError_t e =
        tile_smem(bwd_g_kernel<MODE, IDRV>(), SMEM_SM - SMEM_RESERVED);
    return e;
}

// the staging each mode's last launch took (1 bulk tensor copies, 0
// element copies, -1 none yet), for rrtm_rt_bwd_g_layout
int g_staged[4] = {-1, -1, -1, -1};
int mode_row(int mode) {
    return mode == BANDED ? 0 : mode == FUSED ? 1 : mode == CLDF_OD ? 2 : 3;
}

// A tensor map over `rows` rows of B bytes (compact's int8 mask), boxes
// of box_cols x box_rows bytes; false where it cannot be encoded (base or
// B not a multiple of 16, no entry point).
bool tensor_map_bytes(CUtensorMap* map, const void* base, uint64_t rows,
                      int B, int box_cols, int box_rows) {
    const EncodeTiled enc = encode_tiled();
    if (!enc || ((uintptr_t)base & 15u) || B % 16) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)B, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)B};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t step[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
               dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, G_L2,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE>
cudaError_t launch_bwd_g(const Inputs& in, const Clouds& cl, const int* ngb,
                         const float* wg, const float* ct, const float* rads,
                         const GGrads& gr, const GScratch& sc, const Ddt& dt,
                         cudaStream_t s) {
    // compact: the d/dT instantiation alone (its idrv=0 K6: rtrn_bwd.cu)
    constexpr bool CMP = MODE == COMPACT;
    cudaError_t e;
    if constexpr (CMP)
        e = dt.ct ? prepare_bwd_g<MODE, true>() : cudaErrorInvalidValue;
    else
        e = dt.ct ? prepare_bwd_g<MODE, true>() : prepare_bwd_g<MODE>();
    if (e != cudaSuccess) return e;
    const int L = in.L, B = in.B;
    const int ncld = MODE == FUSED ? 6 : 2;
    // the bulk copies where every operand's rows are 16-byte aligned
    // (compact: the mask's rows too, B % 16 == 0)
    bool vec = map_rows_ok(in.taut, B) && map_rows_ok(in.fracs, B)
               && map_rows_ok(in.play, B) && map_rows_ok(in.plev, B)
               && map_rows_ok(ct, B) && map_rows_ok(rads, B)
               && map_rows_ok(gr.taut, B) && map_rows_ok(gr.fracs, B)
               && map_rows_ok(gr.play, B) && map_rows_ok(gr.plev, B);
    if constexpr (CMP) {
        vec = vec && B % 16 == 0 && ((uintptr_t)cl.c[0] & 15u) == 0;
        for (int i : {1, 4, 5})
            vec = vec && map_rows_ok(cl.c[i], B) && map_rows_ok(gr.c[i], B);
    } else {
        for (int i = 0; i < ncld; ++i)
            vec = vec && map_rows_ok(cl.c[i], B) && map_rows_ok(gr.c[i], B);
    }
    GMaps maps{};
    if (vec) {
        const uint64_t lg = (uint64_t)L * KG;
        const uint64_t lp = (uint64_t)L * rrtm::NGPT_PAD;
        const uint64_t lb = (uint64_t)L * KNB;
        auto map = [&](int id, const float* p, uint64_t rows, int box) {
            return tensor_map_rows(&maps.m[id], p, rows, B, GX, box, G_L2);
        };
        bool ok = map(M_TAUT, in.taut, lg, GH)
                  && map(M_FRACS, in.fracs, lg, GH)
                  && map(M_RADS, rads, (dt.ct ? 6 : 4) * lg, GH)
                  && map(M_GTAUT, gr.taut, lg, GH)
                  && map(M_GFRACS, gr.fracs, lg, GH)
                  && map(M_PLAY, in.play, lb, GH)
                  && map(M_PLEV, in.plev, lb + KNB, GH)
                  && map(M_CT, ct, 4 * (uint64_t)(L + 1), 1)
                  && map(M_GPLAY, gr.play, lb, GH)
                  && map(M_GPLEV, gr.plev, lb + KNB, GH);
        if (MODE == BANDED) {
            ok = ok && map(M_C0, cl.c[0], L, 1)
                 && map(M_C0 + 1, cl.c[1], lb, GH)
                 && map(M_GBC, gr.c[1], lb, GH);
        } else if (CMP) {
            ok = ok && tensor_map_bytes(&maps.m[M_C0], cl.c[0], lp, B, GX, GH)
                 && map(M_C0 + 1, cl.c[1], 2 * (uint64_t)L, 2)
                 && map(M_C0 + 4, cl.c[4], lb, GH)
                 && map(M_C0 + 5, cl.c[5], lb, GH)
                 && map(M_GBC, gr.c[4], lb, GH)
                 && map(M_GBC1, gr.c[5], lb, GH);
        } else {
            for (int q = 0; q < (MODE == FUSED ? 4 : 2); ++q)
                ok = ok && map(M_C0 + q, cl.c[q], lp, GH);
            if (MODE == FUSED)
                ok = ok && map(M_C0 + 4, cl.c[4], lb, GH)
                     && map(M_C0 + 5, cl.c[5], lb, GH)
                     && map(M_GBC, gr.c[4], lb, GH)
                     && map(M_GBC1, gr.c[5], lb, GH);
        }
        // a map that does not encode raises (no fallback)
        if (!ok) return cudaErrorInvalidValue;
    }
    // banded's (compact's) shares in shared memory where they fit, else
    // the scratch
    GScratch sk = sc;
    if (GLayout<MODE>::NSH == 0 || GLayout<MODE>::shares_here(L))
        sk.part = nullptr;
    else if (!sk.part)
        return cudaErrorInvalidValue;
    g_staged[mode_row(MODE)] = (int)vec;
    const dim3 grid(NGRP * ((B + GX - 1) / GX));
    if constexpr (CMP) {
        rt_bwd_g_ddt_kernel<MODE><<<grid, GT, GLayout<MODE>::bytes(L), s>>>(
            maps, in, cl, ngb, wg, ct, rads, gr, sk, (int)vec, dt);
    } else {
        if (dt.ct)
            rt_bwd_g_ddt_kernel<MODE>
                <<<grid, GT, GLayout<MODE>::bytes(L), s>>>(
                    maps, in, cl, ngb, wg, ct, rads, gr, sk, (int)vec, dt);
        else
            rt_bwd_g_kernel<MODE><<<grid, GT, GLayout<MODE>::bytes(L), s>>>(
                maps, in, cl, ngb, wg, ct, rads, gr, sk, (int)vec);
    }
    return cudaGetLastError();
}

// out[0..7] = registers per thread, local memory bytes per thread, static
// and dynamic shared memory per block (at L layers), blocks per SM, the
// ring's slots, threads and columns per block
template <int MODE, bool IDRV = false>
cudaError_t info_bwd_g(int L, int* out) {
    cudaError_t e = prepare_bwd_g<MODE, IDRV>();
    if (e != cudaSuccess) return e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, bwd_g_kernel<MODE, IDRV>());
    if (e != cudaSuccess) return e;
    const int smem = GLayout<MODE>::bytes(L);
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, bwd_g_kernel<MODE, IDRV>(), GT, smem);
    if (e != cudaSuccess) return e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = smem;
    out[4] = blocks;
    out[5] = G_RING;
    out[6] = GT;
    out[7] = GX;
    return cudaSuccess;
}

}  // namespace

namespace {

int bwd_g_entry(const float* taut, const float* fracs, const float* play,
                const float* plev, const float* surf, const int* ngb,
                const float* wg, const float* const* c, const float* ct,
                const float* rads, float* ct_taut, float* ct_fracs,
                float* ct_play, float* ct_plev, float* ct_surf,
                float* const* g, const unsigned* words, int* count,
                float* tpart, const Ddt& dt, int L, int B, int mode,
                void* stream) {
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    const int ncld = mode == FUSED ? 6 : 2;
    // compact: its d/dT instantiation alone, no cotangent of the mask
    const bool cmp = mode == COMPACT;
    if (!rads || !count
        || (mode != BANDED && mode != FUSED && mode != CLDF_OD && !cmp)
        || (mode != BANDED && !words) || (cmp && !dt.ct))
        return (int)cudaErrorInvalidValue;
    if (cmp) {
        for (int i : {1, 4, 5})
            if (!c[i] || !g[i]) return (int)cudaErrorInvalidValue;
        if (!c[0]) return (int)cudaErrorInvalidValue;
    } else {
        for (int i = 0; i < ncld; ++i)
            if (!c[i] || !g[i]) return (int)cudaErrorInvalidValue;
    }
    Inputs in{taut, fracs, play, plev, surf, nullptr, nullptr, nullptr,
              nullptr, L, B};
    Clouds cl{};
    GGrads gr{ct_taut, ct_fracs, ct_play, ct_plev, ct_surf, {}};
    for (int i = 0; i < NCLD; ++i) {
        cl.c[i] = c[i];
        gr.c[i] = g[i];
    }
    const GScratch sc{words, count, tpart};
    cudaStream_t s = (cudaStream_t)stream;
    switch (mode) {
    case BANDED:
        return (int)launch_bwd_g<BANDED>(in, cl, ngb, wg, ct, rads, gr, sc,
                                         dt, s);
    case FUSED:
        return (int)launch_bwd_g<FUSED>(in, cl, ngb, wg, ct, rads, gr, sc, dt,
                                        s);
    case COMPACT:
        return (int)launch_bwd_g<COMPACT>(in, cl, ngb, wg, ct, rads, gr, sc,
                                          dt, s);
    default:
        return (int)launch_bwd_g<CLDF_OD>(in, cl, ngb, wg, ct, rads, gr, sc,
                                          dt, s);
    }
}

}  // namespace

// Inputs as rrtm_rt's (surf (3, 16, B)); c0..c5 the mode's cloud inputs
// (Clouds; unused ones null); ct (4, L+1, B) flux cotangents; rads (4, L,
// 140, B) the radiances K1 kept in the same step (rrtm_rt with rads, in
// the same mode) and, fused and cldf-odcld, words ((B + 31) / 32, L) its
// cloudy-layer words (null in banded) -> ct_taut, ct_fracs (L, 140, B),
// ct_play (L, 16, B), ct_plev (L+1, 16, B), ct_surf (3, 16, B) and g0..g5
// the cloud inputs' cotangents, shaped like them.  count, tpart: the
// scratch rrtm_rt_bwd_g_scratch sizes, count zeroed (tpart may be null
// where it asks for none).  mode: BANDED, FUSED or CLDF_OD (enum Mode).
RRTM_API int rrtm_rt_bwd_g(const float* taut, const float* fracs,
                           const float* play, const float* plev,
                           const float* surf, const int* ngb, const float* wg,
                           const float* c0, const float* c1, const float* c2,
                           const float* c3, const float* c4, const float* c5,
                           const float* ct, const float* rads, float* ct_taut,
                           float* ct_fracs, float* ct_play, float* ct_plev,
                           float* ct_surf, float* g0, float* g1, float* g2,
                           float* g3, float* g4, float* g5,
                           const unsigned* words, int* count, float* tpart,
                           int L, int B, int mode, void* stream) {
    const float* c[NCLD] = {c0, c1, c2, c3, c4, c5};
    float* g[NCLD] = {g0, g1, g2, g3, g4, g5};
    return bwd_g_entry(taut, fracs, play, plev, surf, ngb, wg, c, ct, rads,
                       ct_taut, ct_fracs, ct_play, ct_plev, ct_surf, g, words,
                       count, tpart, Ddt{}, L, B, mode, stream);
}

// rrtm_rt_bwd_g at idrv=1 with the d/dT sweep's adjoint: surf and ct_surf
// (4, 16, B), the fourth row dplankbnd_dt and its cotangent; ct_ddt (2,
// L+1, B) the cotangents of duflx_dt and duflxc_dt; rads (6, L, 140, B),
// what K1 kept in the same mode at idrv=1 (the derivatives P and PC
// too).  Also mode COMPACT: c0 the mask (L, 144, B) int8, c1 cw (L, 2,
// B), c4, c5 abi, abl (L, 16, B) (c2, c3 null) and words K1 kept in
// compact at idrv=1 -> g1, g4, g5 their cotangents (g0, g2, g3 null).
RRTM_API int rrtm_rt_bwd_g_ddt(const float* taut, const float* fracs,
                               const float* play, const float* plev,
                               const float* surf, const int* ngb,
                               const float* wg, const float* c0,
                               const float* c1, const float* c2,
                               const float* c3, const float* c4,
                               const float* c5, const float* ct,
                               const float* rads, float* ct_taut,
                               float* ct_fracs, float* ct_play,
                               float* ct_plev, float* ct_surf, float* g0,
                               float* g1, float* g2, float* g3, float* g4,
                               float* g5, const unsigned* words, int* count,
                               float* tpart, const float* ct_ddt, int L,
                               int B, int mode, void* stream) {
    if (!ct_ddt) return (int)cudaErrorInvalidValue;
    const float* c[NCLD] = {c0, c1, c2, c3, c4, c5};
    float* g[NCLD] = {g0, g1, g2, g3, g4, g5};
    return bwd_g_entry(taut, fracs, play, plev, surf, ngb, wg, c, ct, rads,
                       ct_taut, ct_fracs, ct_play, ct_plev, ct_surf, g, words,
                       count, tpart, Ddt{ct_ddt, nullptr}, L, B, mode,
                       stream);
}

// The scratch rrtm_rt_bwd_g takes in `mode` at L layers and B columns:
// out[0] ints of count (the tickets' counter, then in banded and compact
// one a column tile), out[1] x out[2] floats of tpart (banded past L =
// 381: its blocks x L x GX; compact past L = 153: its blocks x L x 2 x
// GX; else 0).
RRTM_API int rrtm_rt_bwd_g_scratch(int mode, int L, int B, int* out) {
    const int tiles = (B + GX - 1) / GX;
    const bool cmp = mode == COMPACT;
    const bool part = (mode == BANDED && !GLayout<BANDED>::shares_here(L))
                      || (cmp && !GLayout<COMPACT>::shares_here(L));
    out[0] = 1 + (mode == BANDED || cmp ? tiles : 0);
    out[1] = part ? NGRP * tiles : 0;
    out[2] = part ? L * (cmp ? 2 : 1) * GX : 0;
    return 0;
}

// Its tile, band groups and staging in `mode` at L layers: out[0]
// columns a block, out[1] rows of a copy's box, out[2] NGRP, out[3 ..
// 3 + NGRP] the first band of each group, then KNB; out[4 + NGRP] the
// staging of this mode's last launch in the process (1 bulk tensor
// copies, 0 element copies, -1 none yet); out[5 + NGRP] banded's
// cloud-fraction (compact's cw) shares at L: 1 in shared memory, 0 in the
// scratch (-1 in the other modes).
RRTM_API int rrtm_rt_bwd_g_layout(int mode, int L, int* out) {
    if (mode != BANDED && mode != FUSED && mode != CLDF_OD
        && mode != COMPACT)
        return (int)cudaErrorInvalidValue;
    out[0] = GX;
    out[1] = GH;
    out[2] = NGRP;
    const cudaError_t e =
        cudaMemcpyFromSymbol(out + 3, GFIRST, sizeof(int) * (NGRP + 1));
    if (e != cudaSuccess) return (int)e;
    out[4 + NGRP] = g_staged[mode_row(mode)];
    out[5 + NGRP] = mode == BANDED    ? (int)GLayout<BANDED>::shares_here(L)
                    : mode == COMPACT ? (int)GLayout<COMPACT>::shares_here(L)
                                      : -1;
    return 0;
}

// Its launch configuration in `mode` at L layers: out[0..7] as
// rrtm_rt_bwd_mr_info's (the dynamic shared memory at L).
RRTM_API int rrtm_rt_bwd_g_info(int mode, int L, int* out) {
    switch (mode) {
    case BANDED: return (int)info_bwd_g<BANDED>(L, out);
    case FUSED: return (int)info_bwd_g<FUSED>(L, out);
    case CLDF_OD: return (int)info_bwd_g<CLDF_OD>(L, out);
    default: return (int)cudaErrorInvalidValue;
    }
}

// The same of rrtm_rt_bwd_g_ddt's instantiation in `mode` (also
// COMPACT).
RRTM_API int rrtm_rt_bwd_g_ddt_info(int mode, int L, int* out) {
    switch (mode) {
    case COMPACT: return (int)info_bwd_g<COMPACT, true>(L, out);
    case BANDED: return (int)info_bwd_g<BANDED, true>(L, out);
    case FUSED: return (int)info_bwd_g<FUSED, true>(L, out);
    case CLDF_OD: return (int)info_bwd_g<CLDF_OD, true>(L, out);
    default: return (int)cudaErrorInvalidValue;
    }
}
