// K6 in the maxrand mode: the adjoint of K1's maximum-random overlap
// sweep (icld 2/3; idrv = 0 or 1: at idrv=1 with a cotangent of the d/dT
// outputs, (2, L+1, B), the instantiation rt_bwd_mr_ddt_kernel, which
// also runs their adjoint, as K6's in rtrn_bwd.cu does, and takes and
// gives the fourth surface row): flux cotangents (4, L+1, B) ->
// cotangents of taut, fracs (L, 140, B), planklay (L, 16, B), planklev
// (L+1, 16, B), the surface rows (3, 16, B), the per-band cloud od taucb
// (L, 16, B) and the overlap rows (L, 16, B): R_CLDF and the 12 factor
// rows, zeros in the four flag rows.
//
// Replaces the JAX package's backward of the maxrand sweep, which is
// the XLA vjp of rtrnmr.rt_maxrandom (rrtmg_lw_tpu/ops/rtrn_pallas.py:
// 1208, bwd of rt_maxrandom_pallas); there is no Pallas original.  It
// linearizes K1's own forward (rtrn.cuh advance_mr, the port's
// rtrn._sweep_maxrand), so the plain vjp of rtrn.rt_sweep_maxrand is its
// exact reference.
//
// The recursion is linear in the carried radiances and sub-streams, so
// the adjoint runs the up sweep in reverse (top layer down), the surface
// reflection, then the down sweep in reverse (surface up), carrying per
// (column, g) the cotangents of the total-sky radiance, its clear twin
// and the cloudy, clear and correction sub-streams (cr, kr, rr).  The
// forward values each reverse step needs come from K1's gradient-step
// launch (SAVE, rtrn_kernel.cuh): the radiance and its clear twin
// entering the layer, rads (4, L, 140, B), and the three sub-streams
// entering it where the layer is cloudy and does not restart them,
// packed, subs (2 sweeps, 3, K, 140, B): a column's k-th such layer in a
// sweep's order at slot k.  The factors of each step are recomputed from
// taut as K1 forms them.  The discrete gates carry no gradient and are
// recomputed as K1 forms them from the overlap rows: the cloudy layer
// (R_CLDF >= CLOUD_GATE), the restart flags, the clear twin's iclddn
// (R_ICLDDN; the up sweep's anyc from layer 0), the od branches; at od =
// secd * taut = 0 the maximum of the plain version passes half the
// gradient, as torch.maximum does at a tie.
//
// Bound on the H100: bytes.  Per (layer, g, column) the kernel reads
// taut and fracs twice, the radiance entering the layer and its clear
// twin, and writes ct_taut and ct_fracs twice (read-add in the down
// sweep): ~8.5 GB at B=16384, L=60; against that a few tens of flops and
// 1-2 expf per element and sweep (K6-g banded's arithmetic, and in a
// cloudy layer the sub-streams' exchange).
//
// Design: K6-g's tile (bwd_groups.cuh, rtrn_bwd_g.cu).  A block holds 32
// columns (a lane each) and one of the NGRP groups of whole bands, taken
// from a ticket, group-major; warp y takes the group's g-points y, y + 8,
// ... and carries their five cotangents.
// - A step where no column of the tile is cloudy (most of them) runs the
//   clear recurrence alone, its g-points unrolled, lam and mu in
//   registers: the sub-streams' cotangents pass through it.  A cloudy
//   step runs the g-points one at a time with all five carries in shared
//   memory, so that it needs no more registers than a clear one: 128
//   with no spill at two blocks per SM (all five in registers through
//   every step spilled 44 bytes, and ran 8.2 ms against 6.3 in shared
//   memory, on the H100).
// - A prelude over the overlap rows forms, a bit per column and a word
//   per layer, the cloudy layers and iclddn, and counts each column's
//   kept layers in each sweep; the reverse sweeps count them down, so
//   that a kept layer's slot in subs is known where it is reached.
// - Staged rows: every reverse step's rows arrive in a ring of G_RING
//   slots one step ahead, by bulk tensor copies of 32 x 8 boxes: taut,
//   fracs, the radiance entering the layer and its clear twin, in the
//   down sweep the up sweep's ct_taut, ct_fracs and band-summed outputs,
//   planklay, planklev, the two flux cotangents, and where a column of
//   the tile is cloudy at the layer taucb and the layer's 16 overlap
//   rows.  Element by element (cp.async) where a row is not 16-byte
//   aligned.  The sub-streams are read from device memory where a column
//   reads them (a tile's columns may sit at different slots).
// - Band sums (planklay, planklev, taucb, the secant) as K6-g's: written
//   over the slot's rows they were computed from, then warp k sums band
//   k in ascending g: each band's sums are those of the first design,
//   bit for bit.
// - The overlap rows' cotangents (R_CLDF and the sweep's six factors)
//   sum over all 140 g-points, across the tile's groups.  At a layer
//   where a column of the tile is cloudy (elsewhere they are zero) each
//   thread sums its g-points, copies the seven partials over slot rows of
//   its own g-points, and the group's spare warp sums the eight warps into
//   the group's share, 13 floats a (layer, column) in the launch's scratch
//   (R_CLDF's the up sweep's plus the down sweep's).  At the end the
//   tile's last group, whose ticket comes after the others', waits for
//   them and adds the shares in group order into ct_rows, zeros at the
//   clear layers and in the flag rows.  The first design summed g-lanes
//   of two bands each: these sums differ from its in the last bits.
// No atomics on floats: two runs are bitwise equal.
// - The d/dT adjoint (rt_bwd_mr_ddt_kernel; the design: K6-g's,
//   rtrn_bwd_g.cu): the d/dT recursion is advance_ddt's in this mode too,
//   so the overlap factors and the sub-streams take no part in it, and it
//   is linear in the derivative P, so layer l's transmittances get lam x
//   P, lam the cotangent of the derivative leaving the layer (top down)
//   and P the derivative entering it (surface up).  K1's gradient-step
//   launch keeps P and its clear twin PC (rads (6, L, 140, B), planes 4-5;
//   rtrn_kernel.cuh, SAVE), so the whole d/dT adjoint runs in the reverse
//   up sweep: lam and its clear twin's ride in registers through a clear
//   step and in shared memory through a cloudy one (carries 5 and 6,
//   MrLayoutDdt: 8 KB more), the step stages the group's P (and, where a
//   column of the tile has a cloud, PC) rows into the slot's PT and PF
//   slabs, which the up sweep does not read otherwise, and each thread
//   reads its cells before the cloudy step writes its partials over them.
//   The surface step sums the seed's cotangents; the down sweep is the
//   idrv=0 kernel's.  No scratch: the first design wrote lam to 2 (L,
//   140, B) planes in the up sweep and read them back in the down sweep,
//   which recomputed P (2.2 GB at B=16384, L=60 beside the bound, 128
//   registers and 8 B of spill stores).  Two blocks per SM, as the idrv=0
//   kernel.
//
// Shared memory a block: a ring slot 33,024 bytes, the ring of two
// 66,048, the rest 31,904 + 8 a layer (128 of them to align the ring);
// 99,072 at L = 140 (SMEM_BWD_MR), 105,952 at L = 1,000: two blocks per
// SM, 2 x (105,952 + 1,024 reserved) <= 233,472, up to L = 2,220.
#include "bwd_groups.cuh"

namespace {

constexpr int NCAR = 5;                 // lam, mu, cr, kr, rr cotangents
constexpr int NPART = 7;                // R_CLDF and the sweep's factors
constexpr int NSHARE = 1 + 12;          // a group's share of a layer

// rows of the saved radiances (rtrn_kernel.cuh SAVE), and at idrv=1 the
// d/dT derivatives entering each layer and their clear twins
enum Saved { S_D = 0, S_U = 1, S_DC = 2, S_UC = 3, S_P = P_DDT,
             S_PC = P_DDT + 1 };

// the tensor maps of a launch
enum MrMap { N_TAUT, N_FRACS, N_RADS, N_GTAUT, N_GFRACS, N_PLAY, N_PLEV,
             N_TCB, N_CT, N_GPLAY, N_GPLEV, N_GTCB, N_ROWS, NMAP_MR };
struct MrMaps {
    CUtensorMap m[NMAP_MR];
};

// Byte layout of one reverse step in the ring: (row, column) tiles of GX
// columns, a row RB bytes.  The per-g slabs hold the group's g-points
// (GBOX boxes of GH rows); the band blocks GH rows from the group's first
// band; ROWS the layer's 16 overlap rows.  The step writes its per-g
// values to be summed over the bands over TAU (planklay), FR (planklev),
// RAD (secant) and RADC (taucb), and each thread its partials of the
// overlap rows' cotangents over the PT and PF elements of its own
// g-points' rows (read, or read by no thread).
struct MrSlot {
    static constexpr int SLAB = GBOX * GH * RB;
    static constexpr int BAND = GH * RB;
    static constexpr int TAU = 0;
    static constexpr int FR = TAU + SLAB;
    static constexpr int RAD = FR + SLAB;
    static constexpr int RADC = RAD + SLAB;
    static constexpr int PT = RADC + SLAB;          // up sweep's ct_taut
    static constexpr int PF = PT + SLAB;            // and ct_fracs
    static constexpr int PLAY = PF + SLAB;          // (GH, GX)
    static constexpr int PLEV = PLAY + BAND;
    static constexpr int TCB = PLEV + BAND;
    // the down sweep's partials of the band-summed outputs
    static constexpr int PPLAY = TCB + BAND;
    static constexpr int PPLEV = PPLAY + BAND;
    static constexpr int PTCB = PPLEV + BAND;
    static constexpr int CT0 = PTCB + BAND;         // UP or DOWN
    static constexpr int CT1 = CT0 + RB;            // CLR_UP or CLR_DOWN
    static constexpr int ROWS = CT1 + RB;           // (NROW, GX)
    static constexpr int BYTES = ROWS + NROW * RB;
    static_assert(RB % 128 == 0 && BYTES % 128 == 0, "128-byte rows");
    static_assert(NPART <= 2 * GPT, "a thread's partials over its rows");
};

// The block's dynamic shared memory: the ring, the full and empty
// mbarriers of each slot, the block's ticket, the flux weight of every g,
// the first g of every band, the band (0-7 of the group) of each of the
// group's g-points, the bands' secants per column and the secant's
// cotangents, each column's count of kept layers per sweep, each
// thread's count of its column's kept layers not yet reached, the
// carries in shared memory, each thread's partials of the overlap rows'
// cotangents, the cloudy-layer and iclddn words (a bit per column, (2,
// L)), and 128 bytes to align the ring.
template <int NC>
struct MrLayoutN {
    static constexpr int BAR = G_RING * MrSlot::BYTES;
    static constexpr int TICKET = BAR + 2 * G_RING * 8;
    static constexpr int WG = TICKET + 8;                    // (KG)
    static constexpr int GOFF = WG + KG * 4;                 // (KNB + 1)
    static constexpr int RK = GOFF + (KNB + 1) * 4;          // (GR)
    static constexpr int SECD = align16(RK + GR * 4);        // (GNB, GX)
    static constexpr int CSEC = SECD + GNB * GX * 4;         // (GNB, GX)
    static constexpr int NKEPT = CSEC + GNB * GX * 4;        // (2, GX)
    static constexpr int NK = NKEPT + 2 * GX * 4;            // (GT)
    static constexpr int CAR = NK + GT * 4;              // (NC, GPT, GT)
    static constexpr int PART = CAR + NC * GPT * GT * 4;    // (NPART, GT)
    static constexpr int FLAGS = PART + NPART * GT * 4;
    __host__ __device__ static constexpr int bytes(int L) {
        return FLAGS + (2 * L * 4 + 15) / 16 * 16 + 128;
    }
};
using MrLayout = MrLayoutN<NCAR>;
// idrv with a d/dT cotangent: a cloudy step's carries also those of the
// d/dT sweep's adjoint (q = 5, 6)
using MrLayoutDdt = MrLayoutN<NCAR + 2>;

// the budget at L = 140, and two blocks per SM up to L = 2,220
constexpr int SMEM_BWD_MR = 99072;
static_assert(MrLayout::bytes(140) == SMEM_BWD_MR,
              "K6 maxrand's shared memory is the budget");
static_assert(G_BLOCKS_PER_SM * (MrLayout::bytes(2220) + SMEM_RESERVED)
                  <= SMEM_SM
              && G_BLOCKS_PER_SM * (MrLayout::bytes(2221) + SMEM_RESERVED)
                     > SMEM_SM,
              "two maxrand K6 blocks fit an SM up to L = 2,220");

struct MrGrads {
    float* taut;     // (L, 140, B)
    float* fracs;    // (L, 140, B)
    float* play;     // (L, 16, B)
    float* plev;     // (L+1, 16, B)
    float* surf;     // (3, 16, B)
    float* rows;     // (L, 16, B)
    float* taucb;    // (L, 16, B)
};

// The carried cotangents of one (column, g): of the total-sky radiance
// (lam), its clear twin (mu) and the sub-streams (cr, kr, rr).
struct Car {
    float lam, mu, cr, kr, rr;
};

// What a reverse step gives besides the carries.
struct StepGrads {
    float tau, fr, bl, pl, tcb, secd, c, fac[6];
};

// Reverse of one advance_mr() of a layer for one (column, g) (with its
// staged_step, MAXRAND): tau, fr the g's taut and fracs, bl the band's
// Planck row at the layer, pl at the level bounding the step, secd the
// band's secant, tcb its cloud od, cf the layer's cloud fraction, fac
// its six factors of this sweep; rad, radc the radiance and clear twin
// entering the layer, (cr, kr, rr) the sub-streams entering it (read
// only in a cloudy layer without a restart).  k holds the cotangents of
// the step's outputs on entry and of its inputs on exit.  IDRV: dd carries
// the step of the d/dT sweep's adjoint (rtrn.cuh ddt_step_bwd), whose
// cotangents join the factors'.
template <bool IDRV>
__device__ __forceinline__ StepGrads mr_step_bwd(
        float tau, float fr, float bl, float pl, float secd, float tcb,
        float cf, bool cly, bool twin, bool ist, const float* fac,
        float rad, float radc, float cr, float kr, float rr, Car& k,
        DdtStep& dd) {
    StepGrads o;
    const float dp = pl - bl;
    const float x = secd * tau;
    const float od = fmaxf(x, 0.0f);
    float at, tfg, dat, dtfg;
    factors_d(od, od <= 0.06f, at, tfg, dat, dtfg);
    const float src = fr * (bl + tfg * dp);
    float atot = at, tft = tfg, srctot = src, datot = 0.0f, dtft = 0.0f;
    if (cly) {
        const float xt = od + secd * tcb;
        factors_d(xt, xt < 0.06f, atot, tft, datot, dtft);
        srctot = fr * (bl + tft * dp);
    }
    const float gs = at * src;

    // radc' = twin ? radc + (src - radc) at : rn
    const float ct_rn = k.lam + (twin ? 0.0f : k.mu);
    float ct_at = 0.0f, ct_src = 0.0f, ct_atot = 0.0f, ct_srctot = 0.0f,
          ct_gs = 0.0f, ct_radc = 0.0f, ct_rad = 0.0f;
    if (twin) {
        ct_src += k.mu * at;
        ct_at += k.mu * (src - radc);
        ct_radc = k.mu * (1.0f - at);
    }
    o.c = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) o.fac[i] = 0.0f;
    if (cly) {
        const float c = cf;
        const float cr0 = ist ? c * rad : cr;
        const float kr0 = ist ? rad - c * rad : kr;
        const float rr0 = ist ? 0.0f : rr;
        const float ttot = 1.0f - atot;
        const float cldsrc = srctot * atot;
        const float cr1 = cr0 * ttot + c * cldsrc;
        const float kr1 = kr0 * (1.0f - at) + (1.0f - c) * gs;
        const float w = fac[0] * (1.0f - at) + fac[2] * ttot;
        const float radmod = rr0 * w - fac[4] * gs + fac[5] * cldsrc;
        // rn = cr1 + kr1, cr' = cr1 + r, kr' = kr1 - r, rr' = r
        const float ct_r = k.cr - k.kr + k.rr;
        float ct_cr1 = ct_rn + k.cr, ct_kr1 = ct_rn + k.kr;
        // r = -radmod + fac1 (kr1 + radmod) - fac3 (cr1 - radmod)
        const float ct_radmod = -ct_r + ct_r * fac[1] + ct_r * fac[3];
        o.fac[1] = ct_r * (kr1 + radmod);
        o.fac[3] = -ct_r * (cr1 - radmod);
        ct_kr1 += ct_r * fac[1];
        ct_cr1 -= ct_r * fac[3];
        // radmod = rr0 (fac0 (1 - at) + fac2 ttot) - fac4 gs + fac5 cldsrc
        const float ct_rr0 = ct_radmod * w;
        o.fac[0] = ct_radmod * rr0 * (1.0f - at);
        o.fac[2] = ct_radmod * rr0 * ttot;
        ct_at -= ct_radmod * rr0 * fac[0];
        float ct_ttot = ct_radmod * rr0 * fac[2];
        o.fac[4] = -ct_radmod * gs;
        ct_gs -= ct_radmod * fac[4];
        o.fac[5] = ct_radmod * cldsrc;
        float ct_cldsrc = ct_radmod * fac[5];
        // kr1 = kr0 (1 - at) + (1 - c) gs
        const float ct_kr0 = ct_kr1 * (1.0f - at);
        ct_at -= ct_kr1 * kr0;
        o.c -= ct_kr1 * gs;
        ct_gs += ct_kr1 * (1.0f - c);
        // cr1 = cr0 ttot + c cldsrc
        const float ct_cr0 = ct_cr1 * ttot;
        ct_ttot += ct_cr1 * cr0;
        o.c += ct_cr1 * cldsrc;
        ct_cldsrc += ct_cr1 * c;
        // cldsrc = srctot atot, ttot = 1 - atot
        ct_srctot = ct_cldsrc * atot;
        ct_atot = ct_cldsrc * srctot - ct_ttot;
        if (ist) {
            // cr0 = c rad, kr0 = rad - c rad, rr0 = 0
            ct_rad = ct_cr0 * c + ct_kr0 - ct_kr0 * c;
            o.c += ct_cr0 * rad - ct_kr0 * rad;
            k.cr = k.kr = k.rr = 0.0f;
        } else {
            k.cr = ct_cr0;
            k.kr = ct_kr0;
            k.rr = ct_rr0;
        }
    } else {
        // rn = rad + (src - rad) at; the sub-streams pass through
        ct_rad = ct_rn * (1.0f - at);
        ct_src += ct_rn * at;
        ct_at += ct_rn * (src - rad);
    }
    // gs = at src
    ct_at += ct_gs * src;
    ct_src += ct_gs * at;
    k.lam = ct_rad;
    k.mu = ct_radc;
    if constexpr (IDRV)
        ddt_step_bwd(dd, at, atot, cf, cly, ct_at, ct_atot, o.c);

    // factors -> inputs
    o.fr = ct_src * (bl + tfg * dp) + ct_srctot * (bl + tft * dp);
    const float ct_dp = fr * (ct_src * tfg + ct_srctot * tft);
    o.bl = fr * (ct_src + ct_srctot) - ct_dp;
    o.pl = ct_dp;
    float ct_od = ct_at * dat + ct_src * fr * dp * dtfg;
    o.secd = 0.0f;
    o.tcb = 0.0f;
    if (cly) {
        const float ct_xt = ct_atot * datot + ct_srctot * fr * dp * dtft;
        ct_od += ct_xt;
        o.secd += ct_xt * tcb;
        o.tcb = ct_xt * secd;
    }
    const float ct_x = x > 0.0f ? ct_od : (x == 0.0f ? 0.5f * ct_od : 0.0f);
    o.tau = ct_x * secd;
    o.secd += ct_x * tau;
    return o;
}


// The scratch of a launch (GScratch, bwd_groups.cuh): count, the counter
// the tickets are drawn from, then one a column tile (zeroed: the tile's
// groups that have written their shares); part, the groups' shares,
// (blocks, L, NSHARE, GX): R_CLDF, the 6 up factors, the 6 down factors.
// The kernel's body; IDRV: with the d/dT sweep's adjoint (dt), its
// cotangents of each layer's factors added to the up sweep's reverse step
// of the layer, from the derivatives K1 kept (rads planes S_P, S_PC).
// maps: the kernel's __grid_constant__ parameter.
template <bool IDRV>
__device__ __forceinline__ void rt_bwd_mr_body(
        const MrMaps& maps, const Inputs& in, const int* __restrict__ ngb,
        const float* __restrict__ wg, const float* __restrict__ ct,
        const float* __restrict__ rads, const float* __restrict__ subs,
        const MrGrads& gr, const GScratch& sc, int K, int vec,
        const Ddt& dt) {
    using Sl = MrSlot;
    using Lo = std::conditional_t<IDRV, MrLayoutDdt, MrLayout>;
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
    int* nkept = reinterpret_cast<int*>(smem + Lo::NKEPT);
    float* car_s = reinterpret_cast<float*>(smem + Lo::CAR);
    float* part_s = reinterpret_cast<float*>(smem + Lo::PART);
    int* ticket = reinterpret_cast<int*>(smem + Lo::TICKET);
    const int tid = threadIdx.x;
    const int tx = tid % GX, ty = tid / GX;
    int* nk = reinterpret_cast<int*>(smem + Lo::NK) + tid;
    const int L = in.L, B = in.B;
    const size_t Bz = B;
    unsigned* clyw = reinterpret_cast<unsigned*>(smem + Lo::FLAGS);
    unsigned* icdw = clyw + L;
    int* tcount = sc.count + 1;             // the tiles' counters

    // ---- 0. the block's ticket, then its group: bands b0 .. b0 + nb - 1,
    // g-points g0 .. g0 + nr - 1 ----
    for (int i = tid; i < KG; i += GT) {
        wg_s[i] = wg[i];
        if (i == 0 || ngb[i] != ngb[i - 1]) goff[ngb[i]] = i;
    }
    if (tid < 2 * GX) nkept[tid] = 0;
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
    const int tk = *ticket;
    const int ntiles = gridDim.x / NGRP;
    const int grp = tk / ntiles, tile = tk % ntiles;
    const int bt = tile * GX;
    const int nvalid = min(GX, B - bt);
    // lanes past the ragged edge compute on what their slot holds and
    // write nothing; they take part in the staging and the barriers
    const bool valid = tx < nvalid;
    const int b = bt + tx;
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

    // ---- 1. the prelude: the cloudy-layer and iclddn words, and each
    // column's kept layers in the down and the up sweep ----
    {
        int kd = 0, ku = 0;
        for (int l = ty; l < L; l += GY) {
            const float* rw = in.cld + (size_t)l * NROW * Bz + b;
            bool c = false, ic = false;
            if (valid) {
                c = rw[R_CLDF * Bz] >= CLOUD_GATE;
                ic = rw[R_ICLDDN * Bz] > 0.0f;
                kd += c && !(rw[R_IST_DN * Bz] > 0.0f);
                ku += c && !(rw[R_IST_UP * Bz] > 0.0f);
            }
            const unsigned wc = __ballot_sync(0xffffffffu, c);
            const unsigned wi = __ballot_sync(0xffffffffu, ic);
            if (tx == 0) {
                clyw[l] = wc;
                icdw[l] = wi;
            }
        }
        atomicAdd(&nkept[tx], kd);
        atomicAdd(&nkept[GX + tx], ku);
    }
    __syncthreads();
    // a column that keeps more layers in a sweep than the state has slots
    // (a state kept on other rows) stops the launch, as an index out of
    // range does, where it would read slots K1 never wrote
    if (ty == 0 && valid && max(nkept[tx], nkept[GX + tx]) > K) __trap();
    auto slot = [&](int j) { return smem + (j % G_RING) * Sl::BYTES; };
    // IDRV: a column of the tile has a cloud (anyc, iclddn at layer 0): PC
    // is staged only then
    [[maybe_unused]] const bool tcloud = icdw[0] != 0u;

    // ---- the staging of reverse step j: up sweep j < L, layer L-1-j,
    // Planck level l+1, flux rows UP, CLR_UP at level l+1, the up
    // radiance entering l (IDRV: and the d/dT derivatives entering l, P
    // and, where a column of the tile has a cloud, PC, in the PT and PF
    // slabs); down sweep j >= L, layer j-L, Planck level l,
    // rows DOWN, CLR_DOWN at level l, the down radiance at level l+1 and
    // the up sweep's outputs of layer l; taucb (and its partial) and the
    // overlap rows where a column of the tile is cloudy.  The producer
    // first waits until every thread has left the slot's previous step.
    const int nbox = (nr + GH - 1) / GH;
    auto issue = [&](int j) {
        const bool up = j < L;
        const int l = up ? L - 1 - j : j - L;
        const int lev = up ? l + 1 : l;
        const bool has_in = up || l + 1 < L;
        const bool tc = clyw[l] != 0u;
        unsigned char* d = slot(j);
        uint64_t* bar = &full[j % G_RING];
        const int rin = up ? l : l + 1;     // the radiances' layer
        const int ct0 = (up ? UP : DOWN) * (L + 1) + lev;
        const int ct1 = (up ? CLR_UP : CLR_DOWN) * (L + 1) + lev;
        const int nslab = 2 + (has_in ? 2 : 0) + (up ? 0 : 2)
                          + (IDRV && up ? (tcloud ? 2 : 1) : 0);
        const int nband = 2 + (tc ? 1 : 0)
                          + (up ? 0 : 1 + (lev > 0) + (tc ? 1 : 0));
        const int none = 2 + (tc ? NROW : 0);
        if (vec) {
            // warp 0: a box a lane
            if (ty != 0) return;
            if (j >= G_RING)
                mbar_wait(&empty[j % G_RING], (unsigned)(j / G_RING - 1) & 1u);
            if (tx == 0)
                mbar_arrive_expect_tx(
                    bar, (uint32_t)(((nslab * nbox + nband) * GH + none)
                                    * RB));
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
        // its band 0)
        auto slab = [&](int off, int map, const float* src, int row0) {
            copy(off, map, src, row0 + g0, nr, GH);
        };
        auto bands = [&](int off, int map, const float* src, int row0) {
            copy(off, map, src, row0 + b0, vec ? GH : nb, GH);
        };
        slab(Sl::TAU, N_TAUT, in.taut, l * KG);
        slab(Sl::FR, N_FRACS, in.fracs, l * KG);
        if (has_in) {
            slab(Sl::RAD, N_RADS, rads, ((up ? S_U : S_D) * L + rin) * KG);
            slab(Sl::RADC, N_RADS, rads,
                 ((up ? S_UC : S_DC) * L + rin) * KG);
        }
        if (!up) {
            slab(Sl::PT, N_GTAUT, gr.taut, l * KG);
            slab(Sl::PF, N_GFRACS, gr.fracs, l * KG);
        }
        if constexpr (IDRV) {
            if (up) {
                slab(Sl::PT, N_RADS, rads, (S_P * L + l) * KG);
                if (tcloud) slab(Sl::PF, N_RADS, rads, (S_PC * L + l) * KG);
            }
        }
        bands(Sl::PLAY, N_PLAY, in.play, l * KNB);
        bands(Sl::PLEV, N_PLEV, in.plev, lev * KNB);
        if (tc) bands(Sl::TCB, N_TCB, in.taucb, l * KNB);
        if (!up) {
            bands(Sl::PPLAY, N_GPLAY, gr.play, l * KNB);
            if (lev > 0) bands(Sl::PPLEV, N_GPLEV, gr.plev, lev * KNB);
            if (tc) bands(Sl::PTCB, N_GTCB, gr.taucb, l * KNB);
        }
        copy(Sl::CT0, N_CT, ct, ct0, 1, 1);
        copy(Sl::CT1, N_CT, ct, ct1, 1, 1);
        if (tc) copy(Sl::ROWS, N_ROWS, in.cld, l * NROW, NROW, GH);
        if (!vec) mbar_arrive_copies(bar);
    };

    // the carries of the thread's g-point k: lam and mu in registers
    // (while a cloudy step runs, in shared memory: q = 3, 4), the
    // sub-streams' (q = 0, 1, 2: cr, kr, rr) in shared memory
    float lm[2][GPT];
    auto car = [&](int q, int k) -> float& {
        return car_s[(q * GPT + k) * GT + tid];
    };
    // IDRV: the d/dT sweep's carries of each g-point, the cotangents of
    // the derivative and its clear twin in the reverse up sweep
    // (rtrn.ddt_adjoint's lam, lamc); in registers, while a cloudy step
    // runs in shared memory (q = 5, 6)
    constexpr int ND = IDRV ? GPT : 1;
    [[maybe_unused]] float dd[ND], ddc[ND];
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
        lm[0][k] = lm[1][k] = 0.0f;
        car(0, k) = car(1, k) = car(2, k) = 0.0f;
        if constexpr (IDRV) dd[k] = ddc[k] = 0.0f;
    }
    // the column's kept layers of the sweep not yet reached: the slot of
    // the next kept one is *nk - 1
    *nk = nkept[GX + tx];
    const size_t LGB = (size_t)L * KG * Bz;
    const size_t KGB = (size_t)K * KG * Bz;

    // out = v (up sweep) or pv + v (down sweep)
    auto out = [](float* p, float pv, float v, bool add) {
        *p = add ? pv + v : v;
    };

    // ---- 2. one reverse step j ----
    auto step = [&](auto upward, int j) {
        constexpr bool UPW = decltype(upward)::value;
        const int l = UPW ? L - 1 - j : j - L;
        const int lev = UPW ? l + 1 : l;
        unsigned char* s = slot(j);
        auto row = [&](int off) { return reinterpret_cast<float*>(s + off); };
        float *tau_s = row(Sl::TAU), *fr_s = row(Sl::FR),
              *rad_s = row(Sl::RAD), *radc_s = row(Sl::RADC),
              *pt_s = row(Sl::PT), *pf_s = row(Sl::PF);
        const float *play_s = row(Sl::PLAY), *plev_s = row(Sl::PLEV),
                    *tcb_s = row(Sl::TCB), *rows_s = row(Sl::ROWS);
        mbar_wait(&full[j % G_RING], (unsigned)(j / G_RING) & 1u);
        const bool tc = clyw[l] != 0u;
        // the clear twin's flag: up, anyc (cloud anywhere in the column,
        // iclddn at layer 0); down, iclddn at the layer
        const bool twin = (icdw[UPW ? 0 : l] >> tx) & 1u;
        const bool has_in = UPW || l + 1 < L;
        const float cu = row(Sl::CT0)[tx], ccu = row(Sl::CT1)[tx];
        // idrv, up: anyc, and the d/dT cotangents at level lev
        constexpr bool DDT = IDRV && UPW;
        [[maybe_unused]] const bool anyc = (icdw[0] >> tx) & 1u;
        [[maybe_unused]] float cd = 0.0f, ccd = 0.0f;
        if constexpr (DDT) {
            if (valid) {
                cd = dt.ct[(size_t)lev * Bz + b];
                ccd = dt.ct[((size_t)(L + 1) + lev) * Bz + b];
            }
        }
        // One pass over the thread's g-points.  CL: a column of the tile
        // is cloudy at the layer (tc): the cloudy recurrence where the
        // column is, the sub-streams' carries, the overlap rows' factors
        // (read from the slot at each g-point) and the partials of their
        // cotangents, the g-points one at a time with every carry in
        // shared memory (what such a rare step holds in registers stays
        // under the clear step's); else the clear recurrence alone, the
        // g-points unrolled with lam and mu in registers.
        auto pass = [&](auto cloudy) {
            constexpr bool CL = decltype(cloudy)::value;
            const bool cly = CL && ((clyw[l] >> tx) & 1u);
            float cf = 0.0f;
            bool ist = false;
            int slot_k = 0;
            if (cly) {
                cf = rows_s[R_CLDF * GX + tx];
                ist = rows_s[(UPW ? R_IST_UP : R_IST_DN) * GX + tx] > 0.0f;
                // the sub-streams entering a layer that does not restart
                // them: the column's slot in the sweep's packed rows
                if (!ist) slot_k = min(max(--*nk, 0), K - 1);
            }
            const bool read_sub = cly && !ist && valid;
            const float* sub =
                subs + ((size_t)(UPW ? 3 : 0) * K + slot_k) * KG * Bz + b;
            // g-point k of the thread, its carries lam and mu (and, idrv
            // in the up sweep, the d/dT sweep's dl and dlc)
            auto gstep = [&](int k, float& lam, float& mu, float& dl,
                             float& dlc) {
                const int r = ty + GY * k;
                if (r >= nr) return;
                const int g = g0 + r;
                const int e = r * GX + tx, be = rk[r] * GX + tx;
                // the sub-streams' carries pass through a clear layer
                Car c{lam + wg_s[g] * cu, mu + wg_s[g] * ccu, 0.0f, 0.0f,
                      0.0f};
                float fac[6] = {}, tcb = 0.0f, cr = 0.0f, kr = 0.0f,
                      rr = 0.0f;
                if (cly) {
                    c.cr = car(0, k);
                    c.kr = car(1, k);
                    c.rr = car(2, k);
#pragma unroll
                    for (int i = 0; i < 6; ++i)
                        fac[i] = rows_s[((UPW ? R_UP : R_DN) + i) * GX + tx];
                    tcb = tcb_s[be];
                }
                if (read_sub) {
                    const size_t gi = (size_t)g * Bz;
                    cr = sub[gi];
                    kr = sub[KGB + gi];
                    rr = sub[2 * KGB + gi];
                }
                const float rad = has_in ? rad_s[e] : 0.0f;
                const float radc = has_in ? radc_s[e] : 0.0f;
                // idrv, up: the cotangent of the derivative leaving layer
                // l (the clear twin's folded in where it is the same) times
                // the derivatives entering it, K1's P and PC staged in this
                // thread's PT and PF cells (PC selected, not multiplied,
                // where the column has no cloud: the cell is then not
                // staged), the cotangents of the layer's transmittances
                [[maybe_unused]] DdtStep ds{};
                [[maybe_unused]] float lt = 0.0f;
                if constexpr (DDT) {
                    dl += wg_s[g] * cd;
                    dlc += wg_s[g] * ccd;
                    lt = anyc ? dl : dl + dlc;
                    ds.ct_t = lt * pt_s[e];
                    ds.ct_tc = anyc ? dlc * pf_s[e] : 0.0f;
                }
                const StepGrads o = mr_step_bwd<DDT>(
                    tau_s[e], fr_s[e], play_s[be], plev_s[be], secd_s[be],
                    tcb, cf, cly, twin, ist, fac, rad, radc, cr, kr, rr, c,
                    ds);
                lam = c.lam;
                mu = c.mu;
                if constexpr (DDT) {
                    dl = lt * ds.t;
                    dlc = anyc ? dlc * ds.tc : 0.0f;
                }
                if (cly) {
                    car(0, k) = c.cr;
                    car(1, k) = c.kr;
                    car(2, k) = c.rr;
                }
                if (valid) {
                    const size_t gi = ((size_t)l * KG + g) * Bz + b;
                    if constexpr (UPW) {
                        gr.taut[gi] = o.tau;
                        gr.fracs[gi] = o.fr;
                    } else {
                        gr.taut[gi] = pt_s[e] + o.tau;
                        gr.fracs[gi] = pf_s[e] + o.fr;
                    }
                }
                // the per-g values summed over the bands, over the rows
                // read
                tau_s[e] = o.bl;
                fr_s[e] = o.pl;
                rad_s[e] = o.secd;
                radc_s[e] = o.tcb;
                if constexpr (CL) {
                    part_s[tid] += o.c;
#pragma unroll
                    for (int i = 0; i < 6; ++i)
                        part_s[(1 + i) * GT + tid] += o.fac[i];
                }
            };
            if constexpr (CL) {
#pragma unroll
                for (int q = 0; q < NPART; ++q) part_s[q * GT + tid] = 0.0f;
#pragma unroll
                for (int k = 0; k < GPT; ++k) {
                    car(3, k) = lm[0][k];
                    car(4, k) = lm[1][k];
                    if constexpr (DDT) {
                        car(5, k) = dd[k];
                        car(6, k) = ddc[k];
                    }
                }
                if constexpr (DDT) {
#pragma unroll 1
                    for (int k = 0; k < GPT; ++k)
                        gstep(k, car(3, k), car(4, k), car(5, k), car(6, k));
                } else {
                    float none = 0.0f;
#pragma unroll 1
                    for (int k = 0; k < GPT; ++k)
                        gstep(k, car(3, k), car(4, k), none, none);
                }
#pragma unroll
                for (int k = 0; k < GPT; ++k) {
                    lm[0][k] = car(3, k);
                    lm[1][k] = car(4, k);
                    if constexpr (DDT) {
                        dd[k] = car(5, k);
                        ddc[k] = car(6, k);
                    }
                }
                // the thread's partials of the overlap rows' cotangents,
                // over the elements of its own rows of PT and PF
#pragma unroll
                for (int q = 0; q < NPART; ++q)
                    row(q < GPT ? Sl::PT : Sl::PF)[(ty + GY * (q % GPT)) * GX
                                                   + tx] =
                        part_s[q * GT + tid];
            } else {
#pragma unroll
                for (int k = 0; k < GPT; ++k) {
                    if constexpr (DDT) {
                        gstep(k, lm[0][k], lm[1][k], dd[k], ddc[k]);
                    } else {
                        float none = 0.0f;
                        gstep(k, lm[0][k], lm[1][k], none, none);
                    }
                }
            }
        };
        if (tc)
            pass(std::true_type{});
        else
            pass(std::false_type{});
        __syncthreads();          // the per-g values published

        // ---- the band sums: warp k, band b0 + k, in ascending g; the
        // down sweep adds them to the up sweep's, staged in the slot ----
        if (ty < nb) {
            float s_bl = 0.0f, s_pl = 0.0f, s_tcb = 0.0f,
                  ct_sec = csec_s[tid];
#pragma unroll 4
            for (int r = goff[b0 + ty] - g0; r < goff[b0 + ty + 1] - g0;
                 ++r) {
                const int e = r * GX + tx;
                s_bl += tau_s[e];
                s_pl += fr_s[e];
                ct_sec += rad_s[e];
                s_tcb += radc_s[e];
            }
            csec_s[tid] = ct_sec;
            const int be = ty * GX + tx;
            const size_t bi = ((size_t)l * KNB + b0 + ty) * Bz + b;
            const size_t vi = ((size_t)lev * KNB + b0 + ty) * Bz + b;
            if (valid) {
                out(gr.play + bi, UPW ? 0.0f : row(Sl::PPLAY)[be], s_bl,
                    !UPW);
                out(gr.plev + vi, UPW || lev == 0 ? 0.0f
                                                  : row(Sl::PPLEV)[be],
                    s_pl, !UPW && lev > 0);
                // taucb's cotangent is zero outside a cloudy layer: the
                // up sweep writes it, the down sweep adds only in a
                // cloudy one
                if (UPW || ((clyw[l] >> tx) & 1u))
                    out(gr.taucb + bi, UPW ? 0.0f : row(Sl::PTCB)[be], s_tcb,
                        !UPW);
            }
        }
        // ---- the group's share of the overlap rows' cotangents of layer
        // l (the spare warp): the eight warps' partials in warp order;
        // R_CLDF's the up sweep's, then plus the down sweep's ----
        if (ty == GY - 1 && tc && valid) {
            float* sh = sc.part + (((size_t)tk * L + l) * NSHARE) * GX + tx;
#pragma unroll
            for (int q = 0; q < NPART; ++q) {
                const float* pp = row(q < GPT ? Sl::PT : Sl::PF);
                float a = 0.0f;
#pragma unroll
                for (int y = 0; y < GY; ++y)
                    a += pp[(y + GY * (q % GPT)) * GX + tx];
                if (q == 0)
                    sh[0] = UPW ? a : sh[0] + a;
                else
                    sh[(UPW ? q : 6 + q) * GX] = a;
            }
        }
        // the slot is free once every thread has arrived
        fence_proxy_async_smem();
        mbar_arrive(&empty[j % G_RING]);
    };

    issue(0);
    if (1 < L) issue(1);

    // ---- 3. up sweep in reverse: layer L-1 .. 0 ----
    for (int j = 0; j < L; ++j) {
        step(std::true_type{}, j);
        if (j + 2 < L) issue(j + 2);
    }

    // ---- 4. surface reflection in reverse; the sub-streams' cotangents
    // end here (the up sweep starts them at zero).  It adds the surface's
    // cotangent of fracs at layer 0 to the up sweep's; the down sweep's
    // first step reads that back, so it is issued after, as is its second
    // into the slot whose rows the surface step uses.  Layer 0's band
    // sums read TAU and FR of that slot, which em and pb overwrite: every
    // warp is past them first ----
    __syncthreads();
    *nk = nkept[tx];
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
            const float lam0 = lm[0][k] + wg_s[g] * cu;
            const float mu0 = lm[1][k] + wg_s[g] * ccu;
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
            if constexpr (IDRV) {
                // the d/dT seed fracs[0] x dplankbnd_dt takes the
                // cotangent of both derivatives at the surface
                const float dpl =
                    valid ? in.surf[((size_t)3 * KNB + bd) * Bz + b] : 0.0f;
                const float ctd0 = dd[k] + wg_s[g] * cd0
                                   + (ddc[k] + wg_s[g] * ccd0);
                if (valid)
                    gr.fracs[gi] =
                        gr.fracs[gi] + (ct_rad0 * pbnd + ctd0 * dpl);
                dz[r * GX + tx] = ctd0 * fr0;
            } else {
                if (valid) gr.fracs[gi] = gr.fracs[gi] + ct_rad0 * pbnd;
            }
            em[r * GX + tx] = -(lam0 * d0 + mu0 * dc0);
            pb[r * GX + tx] = ct_rad0 * fr0;
            lm[0][k] = lam0 * reflect;
            lm[1][k] = mu0 * reflect;
            car(0, k) = car(1, k) = car(2, k) = 0.0f;
        }
        fence_proxy_async_smem();
        fence_proxy_async_global();
        __syncthreads();
        issue(L);
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
        fence_proxy_async_smem();
        __syncthreads();
    }
    if (L + 1 < 2 * L) issue(L + 1);

    // ---- 5. down sweep in reverse: layer 0 .. L-1 ----
    for (int j = L; j < 2 * L; ++j) {
        step(std::false_type{}, j);
        if (j + 2 < 2 * L) issue(j + 2);
    }

    // ---- 6. the secants, summed over both sweeps ----
    if (ty < nb && valid) gr.surf[(size_t)(b0 + ty) * Bz + b] = csec_s[tid];

    // ---- 7. the overlap rows' cotangents: the tile's last group adds
    // the groups' shares in group order once the others have written
    // theirs (their tickets come first); zeros at the clear layers and in
    // the flag rows ----
    __threadfence();
    __syncthreads();
    if (grp < NGRP - 1) {
        if (tid == 0) atomicAdd(&tcount[tile], 1);
        return;
    }
    if (tid == 0) {
        while (atomicAdd(&tcount[tile], 0) != NGRP - 1) __nanosleep(256);
        __threadfence();
    }
    __syncthreads();
    if (!valid) return;
    for (int l = ty; l < L; l += GY) {
        float v[NSHARE] = {};
        if (clyw[l] != 0u) {
            for (int gp = 0; gp < NGRP; ++gp) {
                const float* sh = sc.part
                    + (((size_t)(gp * ntiles + tile) * L + l) * NSHARE) * GX
                    + tx;
#pragma unroll
                for (int q = 0; q < NSHARE; ++q) v[q] += __ldcg(sh + q * GX);
            }
        }
        float* o = gr.rows + (size_t)l * NROW * Bz + b;
        o[R_CLDF * Bz] = v[0];
        o[R_IST_UP * Bz] = 0.0f;
        o[R_IST_DN * Bz] = 0.0f;
        o[R_ICLDDN * Bz] = 0.0f;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            o[(size_t)(R_UP + i) * Bz] = v[1 + i];
            o[(size_t)(R_DN + i) * Bz] = v[7 + i];
        }
    }
}

__global__ void __launch_bounds__(GT, G_BLOCKS_PER_SM)
rt_bwd_mr_kernel(__grid_constant__ const MrMaps maps, Inputs in,
                 const int* __restrict__ ngb, const float* __restrict__ wg,
                 const float* __restrict__ ct, const float* __restrict__ rads,
                 const float* __restrict__ subs, MrGrads gr, GScratch sc,
                 int K, int vec) {
    rt_bwd_mr_body<false>(maps, in, ngb, wg, ct, rads, subs, gr, sc, K, vec,
                          Ddt{});
}

// K6 maxrand with the d/dT sweep's adjoint (idrv=1 and a cotangent of
// duflx_dt or duflxc_dt), two blocks per SM as the idrv=0 kernel.
__global__ void __launch_bounds__(GT, G_BLOCKS_PER_SM)
rt_bwd_mr_ddt_kernel(__grid_constant__ const MrMaps maps, Inputs in,
                     const int* __restrict__ ngb,
                     const float* __restrict__ wg,
                     const float* __restrict__ ct,
                     const float* __restrict__ rads,
                     const float* __restrict__ subs, MrGrads gr, GScratch sc,
                     int K, int vec, Ddt dt) {
    rt_bwd_mr_body<true>(maps, in, ngb, wg, ct, rads, subs, gr, sc, K, vec,
                         dt);
}

// the shared memory attributes of the kernel, set once per process (at
// the largest dynamic shared memory a block can take: it grows with L)
cudaError_t prepare_bwd_mr() {
    static const cudaError_t e =
        tile_smem(rt_bwd_mr_kernel, SMEM_SM - SMEM_RESERVED);
    return e;
}

cudaError_t prepare_bwd_mr_ddt() {
    static const cudaError_t e =
        tile_smem(rt_bwd_mr_ddt_kernel, SMEM_SM - SMEM_RESERVED);
    return e;
}

// the staging of the last launch in the process (1 bulk tensor copies, 0
// element copies, -1 none yet), for rrtm_rt_bwd_mr_layout
int mr_staged = -1;

// out[0..7] of rrtm_rt_bwd_mr_info for `kernel` at `smem` bytes of
// dynamic shared memory
template <typename Kernel>
int mr_info(Kernel* kernel, int smem, int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, GT,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = smem;
    out[4] = blocks;
    out[5] = G_RING;
    out[6] = GT;
    out[7] = GX;
    return (int)cudaSuccess;
}

int bwd_mr_entry(const float* taut, const float* fracs, const float* play,
                 const float* plev, const float* surf, const float* rows,
                 const float* taucb, const int* ngb, const float* wg,
                 const float* ct, const float* rads, const float* subs,
                 float* ct_taut, float* ct_fracs, float* ct_play,
                 float* ct_plev, float* ct_surf, float* ct_rows,
                 float* ct_taucb, int* count, float* part, const Ddt& dt,
                 int L, int K, int B, void* stream) {
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    if (!rads || !subs || !rows || !taucb || !count || !part || K < 1)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = dt.ct ? prepare_bwd_mr_ddt() : prepare_bwd_mr();
    if (e != cudaSuccess) return (int)e;
    Inputs in{taut, fracs, play, plev, surf, nullptr, nullptr, nullptr,
              nullptr, L, B};
    in.cld = rows;
    in.taucb = taucb;
    const MrGrads gr{ct_taut, ct_fracs, ct_play, ct_plev, ct_surf, ct_rows,
                     ct_taucb};
    // the bulk copies where every staged operand's rows are 16-byte
    // aligned
    const bool vec = map_rows_ok(taut, B) && map_rows_ok(fracs, B)
                     && map_rows_ok(play, B) && map_rows_ok(plev, B)
                     && map_rows_ok(taucb, B) && map_rows_ok(rows, B)
                     && map_rows_ok(ct, B) && map_rows_ok(rads, B)
                     && map_rows_ok(ct_taut, B) && map_rows_ok(ct_fracs, B)
                     && map_rows_ok(ct_play, B) && map_rows_ok(ct_plev, B)
                     && map_rows_ok(ct_taucb, B);
    MrMaps maps{};
    if (vec) {
        const uint64_t lg = (uint64_t)L * KG;
        const uint64_t lb = (uint64_t)L * KNB;
        auto map = [&](int id, const float* p, uint64_t nrows, int box) {
            return tensor_map_rows(&maps.m[id], p, nrows, B, GX, box, G_L2);
        };
        const bool ok = map(N_TAUT, taut, lg, GH)
                        && map(N_FRACS, fracs, lg, GH)
                        && map(N_RADS, rads, (dt.ct ? 6 : 4) * lg, GH)
                        && map(N_GTAUT, ct_taut, lg, GH)
                        && map(N_GFRACS, ct_fracs, lg, GH)
                        && map(N_PLAY, play, lb, GH)
                        && map(N_PLEV, plev, lb + KNB, GH)
                        && map(N_TCB, taucb, lb, GH)
                        && map(N_CT, ct, 4 * (uint64_t)(L + 1), 1)
                        && map(N_GPLAY, ct_play, lb, GH)
                        && map(N_GPLEV, ct_plev, lb + KNB, GH)
                        && map(N_GTCB, ct_taucb, lb, GH)
                        && map(N_ROWS, rows, (uint64_t)L * NROW, GH);
        // a map that does not encode raises (no fallback)
        if (!ok) return (int)cudaErrorInvalidValue;
    }
    mr_staged = (int)vec;
    const GScratch sc{nullptr, count, part};
    const dim3 grid(NGRP * ((B + GX - 1) / GX));
    if (dt.ct)
        rt_bwd_mr_ddt_kernel<<<grid, GT, MrLayoutDdt::bytes(L),
                               (cudaStream_t)stream>>>(
            maps, in, ngb, wg, ct, rads, subs, gr, sc, K, (int)vec, dt);
    else
        rt_bwd_mr_kernel<<<grid, GT, MrLayout::bytes(L),
                           (cudaStream_t)stream>>>(
            maps, in, ngb, wg, ct, rads, subs, gr, sc, K, (int)vec);
    return (int)cudaGetLastError();
}

}  // namespace

// Inputs as rrtm_rt's in the maxrand mode (surf (3, 16, B); rows the
// overlap rows (L, 16, B), taucb (L, 16, B)); ct (4, L+1, B) flux
// cotangents; rads (4, L, 140, B) and subs (2, 3, K, 140, B) the state K1
// kept in the same step (rrtm_rt with rads and subs, maxrand) ->
// ct_taut, ct_fracs (L, 140, B), ct_play (L, 16, B), ct_plev (L+1, 16,
// B), ct_surf (3, 16, B), ct_rows (L, 16, B), ct_taucb (L, 16, B).
// count, part: the scratch rrtm_rt_bwd_mr_scratch sizes, count zeroed.
RRTM_API int rrtm_rt_bwd_mr(const float* taut, const float* fracs,
                            const float* play, const float* plev,
                            const float* surf, const float* rows,
                            const float* taucb, const int* ngb,
                            const float* wg, const float* ct,
                            const float* rads, const float* subs,
                            float* ct_taut, float* ct_fracs, float* ct_play,
                            float* ct_plev, float* ct_surf, float* ct_rows,
                            float* ct_taucb, int* count, float* part, int L,
                            int K, int B, void* stream) {
    return bwd_mr_entry(taut, fracs, play, plev, surf, rows, taucb, ngb, wg,
                        ct, rads, subs, ct_taut, ct_fracs, ct_play, ct_plev,
                        ct_surf, ct_rows, ct_taucb, count, part, Ddt{}, L, K,
                        B, stream);
}

// rrtm_rt_bwd_mr at idrv=1 with the d/dT sweep's adjoint: surf and
// ct_surf (4, 16, B), the fourth row dplankbnd_dt and its cotangent;
// ct_ddt (2, L+1, B) the cotangents of duflx_dt and duflxc_dt; rads (6,
// L, 140, B), what K1 kept in the maxrand mode at idrv=1 (the derivatives
// P and PC too).
RRTM_API int rrtm_rt_bwd_mr_ddt(const float* taut, const float* fracs,
                                const float* play, const float* plev,
                                const float* surf, const float* rows,
                                const float* taucb, const int* ngb,
                                const float* wg, const float* ct,
                                const float* rads, const float* subs,
                                float* ct_taut, float* ct_fracs,
                                float* ct_play, float* ct_plev,
                                float* ct_surf, float* ct_rows,
                                float* ct_taucb, int* count, float* part,
                                const float* ct_ddt, int L, int K, int B,
                                void* stream) {
    if (!ct_ddt) return (int)cudaErrorInvalidValue;
    return bwd_mr_entry(taut, fracs, play, plev, surf, rows, taucb, ngb, wg,
                        ct, rads, subs, ct_taut, ct_fracs, ct_play, ct_plev,
                        ct_surf, ct_rows, ct_taucb, count, part,
                        Ddt{ct_ddt, nullptr}, L, K, B, stream);
}

// The scratch rrtm_rt_bwd_mr takes at L layers and B columns: out[0]
// ints of count (the tickets' counter, then one a column tile), out[1]
// floats of part (the groups' shares: blocks x L x NSHARE x GX).
RRTM_API int rrtm_rt_bwd_mr_scratch(int L, int B, int* out) {
    const int tiles = (B + GX - 1) / GX;
    out[0] = 1 + tiles;
    out[1] = NGRP * tiles * L * NSHARE * GX;
    return 0;
}

// Its tile, band groups and staging: out[0] columns a block, out[1] rows
// of a copy's box, out[2] NGRP, out[3 .. 3 + NGRP] the first band of each
// group, then KNB; out[4 + NGRP] the staging of the last launch in the
// process (1 bulk tensor copies, 0 element copies, -1 none yet); out[5 +
// NGRP] the floats of a group's share of a (layer, column).
RRTM_API int rrtm_rt_bwd_mr_layout(int* out) {
    out[0] = GX;
    out[1] = GH;
    out[2] = NGRP;
    const cudaError_t e =
        cudaMemcpyFromSymbol(out + 3, GFIRST, sizeof(int) * (NGRP + 1));
    if (e != cudaSuccess) return (int)e;
    out[4 + NGRP] = mr_staged;
    out[5 + NGRP] = NSHARE;
    return 0;
}

// Its launch configuration at L layers: out[0..7] = registers per thread,
// local memory bytes per thread, static and dynamic shared memory per
// block (at L), blocks per SM, the ring's slots, threads and columns per
// block.
RRTM_API int rrtm_rt_bwd_mr_info(int L, int* out) {
    cudaError_t e = prepare_bwd_mr();
    if (e != cudaSuccess) return (int)e;
    return mr_info(rt_bwd_mr_kernel, MrLayout::bytes(L), out);
}

// The same of rrtm_rt_bwd_mr_ddt's instantiation.
RRTM_API int rrtm_rt_bwd_mr_ddt_info(int L, int* out) {
    cudaError_t e = prepare_bwd_mr_ddt();
    if (e != cudaSuccess) return (int)e;
    return mr_info(rt_bwd_mr_ddt_kernel, MrLayoutDdt::bytes(L), out);
}
