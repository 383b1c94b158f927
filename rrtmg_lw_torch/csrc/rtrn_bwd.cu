// K6: the adjoint of the RT sweep kernel (K1), clear sky and compact
// McICA clouds: flux cotangents (4, L+1, B) -> cotangents of taut, fracs
// (L, 140, B), planklay (L, 16, B), planklev (L+1, 16, B), the surface
// rows (3, 16, B), and, cloudy, cw (L, 2, B), abi, abl (L, 16, B).  At
// idrv=1 with a cotangent of the d/dT outputs (2, L+1, B) clear's
// instantiation rt_bwd_ddt_kernel also runs their adjoint, and the
// surface rows are (4, 16, B), the fourth dplankbnd_dt (below); compact's
// runs on K6-g's tile (rtrn_bwd_g.cu, rt_bwd_g_ddt_kernel<COMPACT>).
//
// Replaces the JAX package's backward of the TPU sweep, which was
// unrolled XLA (rrtmg_lw_tpu/ops/rtrn_bwd.py:259 rt_bwd_fluxes, under
// the column-chunked vjp of ops/_vjp_chunk.py); there is no Pallas
// original.  It linearizes K1's own forward (rtrn.cuh, the port's
// rtrn.py with the two-division Planck transition), so the plain vjp of
// rtrn.rt_sweep_blocked is its exact reference.
//
// The sweeps are linear in the carried radiances, so the adjoint runs
// the up sweep in reverse (top level down), the surface reflection,
// then the down sweep in reverse (surface up), carrying the radiance
// cotangents; the flux cotangents enter at each level times wg[g].
// The reverse steps need the forward radiances entering each layer, in
// the opposite order to the one they were made in: K1 keeps them in the
// gradient step (rtrn_kernel.cuh, SAVE) and K6 reads them, `rads` (2 x
// (L, 140, B) floats, 4 when cloudy: the down radiance at level l, the
// up radiance entering layer l, their clear twins), so it runs no
// forward sweep of its own.  The factors of each step (gas and cloud
// absorptivities, Planck transitions) are recomputed from taut as K1's
// sweeps form them.  The discrete gates carry no gradient and are
// recomputed as K1 forms them: cloudy_lay (a warp ballot over the
// staged mask of the next step, as K1's), the clear twin's iclddn (from
// the highest cloudy layer) and anyc, cldf >= 0.5, cwp >= CLDMIN, the od
// branches.  The highest cloudy layer of each column comes from one pass
// over the int8 mask at the start of the block, in 16-byte rows (141 MB
// read in all, against a second copy of the flags from K1).  At od =
// secd * taut = 0 the maximum of the plain version passes half the
// gradient, as torch.maximum (and jnp.maximum) does at a tie.
//
// Bound on the H100: bytes.  Per (layer, g, column) the kernel reads
// taut and fracs twice (once per reverse sweep), the mask twice and each
// of the 2 or 4 radiances once, and writes ct_taut, ct_fracs twice
// (read-add in the second reverse sweep): ~8.6 GB at B=16384, L=60
// cloudy.  Each input read once and each output written once, the bytes
// are ~5.1 GB (1.5 ms at 3.35 TB/s), 2.2 GB of them the radiances;
// against that a few tens of flops and 2-3 expf per element and sweep.
//
// Design.  A block holds 16 columns x 16 g-lanes (256 threads, K1's
// tile, rtrn.cuh), two blocks per SM at <= 128 registers; each thread
// carries the radiance cotangents of 9 of the 140 g-points of its column
// in registers.  The band, diffusivity secant and flux weight of every g
// live in shared memory, as K1's do, and so does the running secant
// cotangent of every (g, column).
// - Staged levels: each reverse step's rows (taut, fracs, the radiance
//   it reads and, compact, its clear twin, the Planck rows of the 16
//   bands, the two flux cotangents; compact: the int8 mask and cw) are
//   copied into a ring of RING levels by cp.async one step ahead, 16
//   bytes a copy where the rows are 16-byte aligned and the tile full,
//   element by element otherwise; a thread waits on the mbarrier of the
//   slot it reads.  The up sweep's cotangents of taut and fracs, which
//   the down sweep adds to, come from device memory: clear loads a
//   step's at its top, compact each g's before its arithmetic (at 128
//   registers it cannot hold 18 more); the band-summed ones are loaded
//   before the step's first barrier, which hides their latency.
// - Registers: the per-g offsets are recomputed at every step from an
//   opaque g-lane (rtrn.cuh opaque), not held through the sweep; that
//   keeps compact at 128 registers without a spill.
// - Band sums: the per-g values to be summed over g (planklay and
//   planklev; compact also abi, abl and the two of cw) are summed per
//   band in ascending g by thread (column, band), and those of cw then
//   over the bands in band order.  Clear keeps them in gp_s, two
//   buffers: one block barrier per level, as the next step's barrier
//   frees the buffer of two steps back.  Compact writes the first four
//   over the rows of the step's slot that they were computed from (the
//   ring could not hold the radiances beside a gp_s of all six) and the
//   two of cw in gp_s: two barriers per level, the second freeing the
//   slot and gp_s, publishing the cw band sums, which lanes 0-1 sum
//   after it, and the next step's cloudy-layer ballots.
// No atomics on floats: two runs are bitwise equal.
//
// The d/dT outputs (idrv=1; rtrn.cuh advance_ddt) sweep up linearly from
// the surface seed fracs[0] x dplankbnd_dt through each layer's
// transmittance t (cly ? cf (1 - atot) + (1 - cf) (1 - at) : 1 - at; the
// clear twin's 1 - at where the column has a cloud); no source and no
// reflection enter.  Their adjoint (the plain twin: rtrn.ddt_adjoint)
// needs at each layer the cotangent lam of the derivative leaving it,
// made top down, and the derivative P entering it, made surface up; K6's
// reverse up sweep visits the layers top down and its reverse down sweep
// surface up, each recomputing the layer's factors.  So the up sweep
// carries lam (and the clear twin's) beside the radiance cotangents and
// writes it to a scratch (rtrn.cuh Ddt: 1 or 2 (L, 140, B) planes), the
// surface step turns it into the seed's cotangents (fracs at layer 0;
// surf's row 3, summed per band in g order as row 2), and the down sweep
// carries P, reads lam back and adds lam P dt/d(at, atot) to the layer's
// factors' cotangents (ddt_step_bwd), whose chain to taut, the secant and
// cw, abi, abl is the step's own.  The body is shared: the idrv=0 kernel
// is it without these terms, its code as before.  The d/dT carries take
// registers: clear's 120 still fit two blocks per SM, its scratch moves
// 1.1 GB besides its bound's bytes at B=16384, L=60.  Compact's took 192
// at one block per SM (7.6x its bound): it runs on K6-g's tile
// (rtrn_bwd_g.cu), and rt_bwd_ddt_kernel is clear's alone.
//
// Shared memory a block (bytes):        clear    compact
//   ring slot                          29,056     40,384
//   ring of RING = 2 slots             58,112     80,768
//   gp_s (buffers x 2 x 8,960)         35,840     17,920
//   secant cotangents (KG x KX)         8,960      8,960
//   the rest (BwdLayout)                2,304      4,384
//   total (SMEM_BWD)                  105,216    112,032
// Two blocks per SM: 2 x (112,032 + 1,024 reserved) <= 233,472.  Block
// barriers per level: clear 1, compact 2.
#include "rtrn.cuh"

namespace {

using namespace rrtm::rt;

struct Grads {
    float* taut;     // (L, 140, B)
    float* fracs;    // (L, 140, B)
    float* play;     // (L, 16, B)
    float* plev;     // (L+1, 16, B)
    // (3, 16, B): secdiff, semiss, plankbnd; idrv with the d/dT adjoint
    // (4, 16, B), + dplankbnd_dt
    float* surf;
    float* cw;       // (L, 2, B)
    float* abi;      // (L, 16, B)
    float* abl;      // (L, 16, B)
};

// Per-g cotangents of one step's inputs that are reduced over g.
enum GQ { Q_PLAY, Q_PLEV, Q_ABI, Q_ABL, Q_CW0, Q_CW1, NQ };
static_assert(Q_ABL == 3, "compact: four quantities over the slot's rows");

constexpr int RING = 2;                     // levels in the ring

// Byte layout of one reverse step in the ring: the (g or band or row,
// column) tiles of its inputs, KX columns each.  Compact's step writes
// its per-g values of planklay, planklev, abi and abl over its own
// TAU, FR and RAD rows (in that order, one quantity a row), each thread
// over the elements it has read.
template <bool CLOUDY>
struct BwdSlot {
    static constexpr int ROW = KG * KX * 4;          // a per-g row
    static constexpr int BAND_ROW = KX * 4;
    // the radiances the step reads: the total-sky one and, compact, its
    // clear twin
    static constexpr int NRAD = CLOUDY ? 2 : 1;
    static constexpr int TAU = 0;
    static constexpr int FR = TAU + ROW;
    static constexpr int RAD = FR + ROW;
    static constexpr int PLAY = RAD + NRAD * ROW;
    static constexpr int PLEV = PLAY + KNB * BAND_ROW;
    static constexpr int CT = PLEV + KNB * BAND_ROW;   // flux cotangents
    static constexpr int CW = CT + 2 * BAND_ROW;       // compact: cw (2, KX)
    static constexpr int MASK = CW + 2 * BAND_ROW;     // compact: (KG, KX)
    static constexpr int BYTES = align16(CLOUDY ? MASK + KG * KX : CW);
};

// The block's dynamic shared memory: the ring, gp_s (clear: the per-g
// values of planklay and planklev, two buffers; compact: those of the
// two water paths), one mbarrier per slot, compact's cw band sums and
// warp ballots, the band and weight of every g, the columns' secants
// per band, the first g of every band, compact's highest cloudy layer
// per column, and the running secant cotangent of every (g, column),
// summed over both sweeps.
template <bool CLOUDY>
struct BwdLayout {
    using S = BwdSlot<CLOUDY>;
    static constexpr int NGP = CLOUDY ? 1 : 2;      // gp_s buffers
    static constexpr int GP = RING * S::BYTES;      // (NGP, 2, KG, KX)
    static constexpr int BAR = GP + NGP * 2 * S::ROW;
    static constexpr int BPART = BAR + 8 * RING;    // (2, KNB, KX)
    static constexpr int CLYW = BPART + (CLOUDY ? 2 * KNB * KX * 4 : 0);
    static constexpr int NGB = CLYW + (CLOUDY ? KW * 4 : 0);
    static constexpr int WG = NGB + KG * 4;
    static constexpr int SECD = WG + KG * 4;          // (KNB, KX)
    static constexpr int GOFF = SECD + KNB * KX * 4;  // (KNB + 1)
    static constexpr int HI = GOFF + (KNB + 1) * 4;   // (KX)
    static constexpr int CTSEC = align16(HI + KX * 4);  // (KG, KX)
    static constexpr int BYTES = CTSEC + S::ROW;
};

// the budget of the header
constexpr int SMEM_BWD[2] = {105216, 112032};
static_assert(BwdLayout<false>::BYTES == SMEM_BWD[0]
              && BwdLayout<true>::BYTES == SMEM_BWD[1],
              "K6's shared memory is the header's budget");
static_assert(BLOCKS_PER_SM * (SMEM_BWD[1] + SMEM_RESERVED) <= SMEM_SM
              && BLOCKS_PER_SM * (SMEM_BWD[0] + SMEM_RESERVED) <= SMEM_SM,
              "two K6 blocks fit an SM");
static_assert(KNB * KX == KT, "one secant a thread");

// Reverse of one advance() of a layer for one (column, g) with inputs
// tau, fr, the Planck rows of its band at the layer (bl) and at the
// level bounding the step (pl), the secant, mask value m and the
// layer's water paths: lam, mu are the cotangents of the outgoing
// total-sky and clear radiances on entry and of the incoming ones (rad,
// radc) on exit.  Writes the per-g values to be reduced into gp
// (planklay, planklev, abi, abl) and gw (cw), KG * KX floats a quantity,
// and returns the cotangents of taut and fracs; adds the secant's to
// ct_secd.  abi, abl point at the band's coefficients, read only where a
// water path is nonzero.
// IDRV: dd carries the step of the d/dT sweep's adjoint (rtrn.cuh
// ddt_step_bwd), whose cotangents join the factors' here.
template <bool CLOUDY, bool IDRV>
__device__ __forceinline__ void step_bwd(float tau, float fr, float bl,
                                         float pl, float secd, float m,
                                         float cw0, float cw1, bool cly,
                                         bool twin, float rad, float radc,
                                         const float* abi, const float* abl,
                                         float& lam, float& mu,
                                         float& ct_tau, float& ct_fr,
                                         float& ct_secd, float* gp,
                                         float* gw, DdtStep& dd) {
    const float dp = pl - bl;
    const float x = secd * tau;
    const float od = fmaxf(x, 0.0f);
    float at, tfg, dat, dtfg;
    factors_d(od, od <= 0.06f, at, tfg, dat, dtfg);
    const float src = fr * (bl + tfg * dp);

    // forward cloud quantities (cf = ef = 0 in a clear step)
    float cf = 0.0f, ef = 0.0f, atot = at, srctot = src;
    float datot = 0.0f, dtft = 0.0f, tft = tfg, ecl = 1.0f, odcld = 0.0f;
    float ciwp = 0.0f, clwp = 0.0f, ai = 0.0f, al = 0.0f;
    bool gate = false, active = false;
    if (CLOUDY) {
        cf = m;
        gate = cf >= 0.5f;
        ciwp = cw0 * cf;
        clwp = cw1 * cf;
        ai = ciwp == 0.0f ? 0.0f : *abi;
        al = clwp == 0.0f ? 0.0f : *abl;
        const float cwp = ciwp + clwp;
        active = cf >= CLDMIN && cwp >= CLDMIN;
        odcld = active ? ciwp * ai + clwp * al : 0.0f;
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
          ct_srctot = 0.0f;
    float ct_radc = 0.0f;
    if (twin) {
        ct_src += mu * at;
        ct_at += mu * (src - radc);
        ct_radc = mu * (1.0f - at);
    }
    float ct_rad;
    if (cly) {
        ct_rad = ct_rn * (1.0f - (at + ef * (1.0f - at)));
        ct_at += ct_rn * (src - rad * (1.0f - ef) - cf * src);
        ct_ef = -ct_rn * rad * (1.0f - at);
        ct_src += ct_rn * at * (1.0f - cf);
        ct_atot = ct_rn * cf * srctot;
        ct_srctot = ct_rn * cf * atot;
    } else {
        ct_rad = ct_rn * (1.0f - at);
        ct_src += ct_rn * at;
        ct_at += ct_rn * (src - rad);
    }
    lam = ct_rad;
    mu = ct_radc;
    if constexpr (IDRV) {
        float ct_cf = 0.0f;     // compact's cf is the mask: no gradient
        ddt_step_bwd(dd, at, atot, cf, cly, ct_at, ct_atot, ct_cf);
    }

    // factors -> inputs
    ct_fr = ct_src * (bl + tfg * dp) + ct_srctot * (bl + tft * dp);
    const float ct_dp = fr * (ct_src * tfg + ct_srctot * tft);
    gp[Q_PLAY * KG * KX] = fr * (ct_src + ct_srctot) - ct_dp;
    gp[Q_PLEV * KG * KX] = ct_dp;
    float ct_od = ct_at * dat + ct_src * fr * dp * dtfg;
    if (CLOUDY) {
        const float ct_xt = ct_atot * datot + ct_srctot * fr * dp * dtft;
        ct_od += ct_xt;
        float ct_ciwp = 0.0f, ct_clwp = 0.0f, ct_ai = 0.0f, ct_al = 0.0f;
        if (gate) {
            const float ct_odce = ct_xt + ct_ef * cf * ecl;
            ct_secd += ct_odce * odcld;
            if (active) {
                const float ct_odcld = ct_odce * secd;
                ct_ciwp = ct_odcld * ai;
                ct_ai = ct_odcld * ciwp;
                ct_clwp = ct_odcld * al;
                ct_al = ct_odcld * clwp;
            }
        }
        gp[Q_ABI * KG * KX] = ciwp == 0.0f ? 0.0f : ct_ai;
        gp[Q_ABL * KG * KX] = clwp == 0.0f ? 0.0f : ct_al;
        gw[0] = ct_ciwp * cf;
        gw[KG * KX] = ct_clwp * cf;
    }
    const float ct_x = x > 0.0f ? ct_od : (x == 0.0f ? 0.5f * ct_od : 0.0f);
    ct_tau = ct_x * secd;
    ct_secd += ct_x * tau;
}

// Thread (tx, ty) gets the sums over the g-points of band ty of the NQS
// per-g quantities in gp[q][g][tx], in g order.
template <int NQS>
__device__ __forceinline__ void band_sums(const float* gp, const int* goff,
                                          float* s) {
    const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
    for (int q = 0; q < NQS; ++q) {
        float a = 0.0f;
        for (int g = goff[ty]; g < goff[ty + 1]; ++g)
            a += gp[(q * KG + g) * KX + tx];
        s[q] = a;
    }
}

// The kernel's body; IDRV: with the d/dT sweep's adjoint (dt), its
// cotangents of each layer's factors added to the down sweep's reverse
// step of the layer.
template <bool CLOUDY, bool IDRV>
__device__ __forceinline__ void rt_bwd_body(
        const Inputs& in, const int* __restrict__ ngb,
        const float* __restrict__ wg, const float* __restrict__ ct,
        const float* __restrict__ rads, const Grads& gr, const Ddt& dt) {
    using Sl = BwdSlot<CLOUDY>;
    using Lo = BwdLayout<CLOUDY>;
    constexpr int NQS = CLOUDY ? 4 : 2;     // quantities in gp (step_bwd)
    extern __shared__ __align__(16) unsigned char smem[];
    float* gp_s = reinterpret_cast<float*>(smem + Lo::GP);
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + Lo::BAR);
    float* bpart = reinterpret_cast<float*>(smem + Lo::BPART);
    unsigned* clyw = reinterpret_cast<unsigned*>(smem + Lo::CLYW);
    int* ngb_s = reinterpret_cast<int*>(smem + Lo::NGB);
    float* wg_s = reinterpret_cast<float*>(smem + Lo::WG);
    float* secd_s = reinterpret_cast<float*>(smem + Lo::SECD);
    int* goff = reinterpret_cast<int*>(smem + Lo::GOFF);
    int* hi_s = reinterpret_cast<int*>(smem + Lo::HI);
    float* ctsec_s = reinterpret_cast<float*>(smem + Lo::CTSEC);

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * KX + tx;
    const int warp = tid >> 5, lane = tid & 31;
    const int L = in.L, B = in.B;
    const size_t Bz = B;
    const int bt = blockIdx.x * KX;
    const int nvalid = min(KX, B - bt);
    // lanes past the ragged edge compute nothing and write nothing; they
    // take part in the staging, the ballots and the barriers
    const bool valid = tx < nvalid;
    const int b = bt + tx;
    for (int i = tid; i < KG; i += KT) {
        ngb_s[i] = ngb[i];
        wg_s[i] = wg[i];
        if (i == 0 || ngb[i] != ngb[i - 1]) goff[ngb[i]] = i;
    }
    if (tid == 0) goff[KNB] = KG;
    secd_s[tid] = in.surf[(size_t)(tid / KX) * Bz + bt
                          + min(tid % KX, nvalid - 1)];
    if (tid < KX) hi_s[tid] = -1;
    if (tid == 0)
        for (int r = 0; r < RING; ++r) mbar_init(&bar[r], KT);
    __syncthreads();

    // 16-byte copies of a full tile where the rows allow them
    const bool full = nvalid == KX;
    const bool v4 = full && rows16<4>(in.taut, B) && rows16<4>(in.fracs, B)
                    && rows16<4>(in.play, B) && rows16<4>(in.plev, B)
                    && rows16<4>(ct, B) && rows16<4>(rads, B)
                    && (!CLOUDY || rows16<4>(in.cw, B));
    const bool v1 = CLOUDY && full && rows16<1>(in.mask, B);
    const size_t LGB = (size_t)L * KG * Bz;

    // Reverse step j: up sweep j < L, layer L-1-j, Planck level l+1, flux
    // rows UP, CLR_UP at level l+1, the up radiance entering l; down
    // sweep j >= L, layer j-L, Planck level l, rows DOWN, CLR_DOWN at
    // level l, the down radiance at level l+1.  Copy its rows into its
    // slot and arm the slot's mbarrier with this thread's copies.
    auto stage_step = [&](int j) {
        const bool up = j < L;
        const int l = up ? L - 1 - j : j - L;
        const int lev = up ? l + 1 : l;
        unsigned char* s = smem + (j % RING) * Sl::BYTES;
        const int t = opaque(threadIdx.y * KX + threadIdx.x);
        auto rows = [&](int off, const float* p, int n, size_t stride) {
            stage<4>(s + off, reinterpret_cast<const unsigned char*>(p), n,
                     stride * 4, nvalid, v4, t);
        };
        const size_t gl = (size_t)l * KG * Bz + bt;
        rows(Sl::TAU, in.taut + gl, KG, Bz);
        rows(Sl::FR, in.fracs + gl, KG, Bz);
        // up: U (and Uc) entering l; down: D (and Dc) at level l+1
        if (up || l + 1 < L) {
            const float* r = rads + (up ? LGB + gl : gl + KG * Bz);
            rows(Sl::RAD, r, KG, Bz);
            if constexpr (CLOUDY)
                rows(Sl::RAD + Sl::ROW, r + 2 * LGB, KG, Bz);
        }
        rows(Sl::PLAY, in.play + (size_t)l * KNB * Bz + bt, KNB, Bz);
        rows(Sl::PLEV, in.plev + (size_t)lev * KNB * Bz + bt, KNB, Bz);
        // the flux rows UP and CLR_UP (DOWN and CLR_DOWN) at level lev
        rows(Sl::CT,
             ct + ((size_t)(up ? UP : DOWN) * (L + 1) + lev) * Bz + bt, 2,
             (size_t)(CLR_UP - UP) * (L + 1) * Bz);
        if constexpr (CLOUDY) {
            rows(Sl::CW, in.cw + (size_t)l * 2 * Bz + bt, 2, Bz);
            stage<1>(s + Sl::MASK,
                     reinterpret_cast<const unsigned char*>(
                         in.mask + (size_t)l * rrtm::NGPT_PAD * Bz + bt),
                     KG, Bz, nvalid, v1, t);
        }
        mbar_arrive_copies(&bar[j % RING]);
    };
    auto slot = [&](int j) -> const unsigned char* {
        return smem + (j % RING) * Sl::BYTES;
    };
    auto wait_step = [&](int j) {
        mbar_wait(&bar[j % RING], (unsigned)(j / RING) & 1u);
    };
    // compact: this warp's ballot of the columns with a cloudy g-point at
    // step j, into clyw
    auto ballot_step = [&](int j) {
        const int8_t* m = reinterpret_cast<const int8_t*>(slot(j) + Sl::MASK);
        bool mine = false;
        if (valid) {
#pragma unroll
            for (int k = 0; k < KGPT; ++k) {
                const int g = ty + k * KY;
                if (g < KG) mine |= (float)m[g * KX + tx] >= 0.5f;
            }
        }
        const unsigned bal = __ballot_sync(0xffffffffu, mine);
        if (lane == 0) clyw[warp] = bal;
    };

    for (int j = 0; j < RING - 1 && j < 2 * L; ++j) stage_step(j);

    // ---- 1. compact: the highest cloudy layer of each column; warp w
    // takes layers w, w + KW, ..., its lanes the 140 rows of a layer in
    // 16-byte pieces (16 columns) ----
    if constexpr (CLOUDY) {
        int top = -1;
        for (int l = warp; l < L; l += KW) {
            unsigned bits = 0u;
            for (int g = lane; g < KG; g += 32) {
                const int8_t* row =
                    in.mask + ((size_t)l * rrtm::NGPT_PAD + g) * Bz + bt;
                if (v1) {
                    const uint4 v = *reinterpret_cast<const uint4*>(row);
                    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                    for (int c = 0; c < KX; ++c)
                        bits |= (unsigned)((float)(int8_t)(w[c / 4]
                                                           >> (8 * (c % 4)))
                                           >= 0.5f) << c;
                } else {
                    for (int c = 0; c < nvalid; ++c)
                        bits |= (unsigned)((float)row[c] >= 0.5f) << c;
                }
            }
            bits = __reduce_or_sync(0xffffffffu, bits);
            if ((bits >> lane) & 1u) top = l;       // lane = column
        }
        if (lane < KX && top >= 0) atomicMax(&hi_s[lane], top);
        wait_step(0);
        ballot_step(0);
    }
    __syncthreads();
    const int hi = CLOUDY && valid ? hi_s[tx] : -1;  // highest cloudy layer
    const bool anyc = hi >= 0;

    float lam[KGPT], mu[KGPT], ct_fr0[KGPT];
    // IDRV: the d/dT sweep's carries of each g-point, the cotangents of
    // the derivative and its clear twin in the reverse up sweep, from the
    // surface step on the derivatives themselves (rtrn.ddt_adjoint)
    constexpr int ND = IDRV ? KGPT : 1;
    [[maybe_unused]] float dd[ND], ddc[ND];
#pragma unroll
    for (int k = 0; k < KGPT; ++k) {
        lam[k] = mu[k] = ct_fr0[k] = 0.0f;
        if constexpr (IDRV) dd[k] = ddc[k] = 0.0f;
        if (ty + k * KY < KG) ctsec_s[(ty + k * KY) * KX + tx] = 0.0f;
    }
    auto gp_buf = [&](int j) {
        return gp_s + (Lo::NGP == 2 ? (j & 1) * 2 * KG * KX : 0);
    };

    // ---- 2. one reverse step (j: stage_step); FIRST: the first of the
    // down sweep (layer 0), which adds the surface's fracs cotangent ----
    auto step = [&](auto upward, auto first, int j) {
        constexpr bool UPW = decltype(upward)::value;
        constexpr bool FIRST = decltype(first)::value;
        const int l = UPW ? L - 1 - j : j - L;
        const int lev = UPW ? l + 1 : l;
        if (j + RING - 1 < 2 * L) stage_step(j + RING - 1);
        wait_step(j);
        unsigned char* s = smem + (j % RING) * Sl::BYTES;
        // planklay, planklev (abi, abl): clear gp_s, compact over the
        // slot's TAU, FR and RAD rows; compact's cw in gp_s
        float* gp = CLOUDY ? reinterpret_cast<float*>(s) : gp_buf(j);
        float* gw = gp_s;
        if (valid) {
            const float* ct_s = reinterpret_cast<const float*>(s + Sl::CT);
            const float cu = ct_s[tx], ccu = ct_s[KX + tx];
            bool cly = false;
            float cw0 = 0.0f, cw1 = 0.0f;
            if constexpr (CLOUDY) {
                unsigned w = 0u;
#pragma unroll
                for (int i = 0; i < KW; ++i) w |= clyw[i];
                w |= w >> 16;                 // lanes 16-31: odd g-lanes
                cly = (w >> tx) & 1u;
                const float* cw_s =
                    reinterpret_cast<const float*>(s + Sl::CW);
                cw0 = cw_s[tx];
                cw1 = cw_s[KX + tx];
            }
            const bool twin = UPW ? anyc : l <= hi;
            // idrv: the up sweep's d/dT cotangents at level lev; the down
            // sweep's scratch rows of layer l
            [[maybe_unused]] float cd = 0.0f, ccd = 0.0f;
            [[maybe_unused]] float lin[ND], linc[ND];
            if constexpr (IDRV && UPW) {
                cd = dt.ct[(size_t)lev * Bz + b];
                ccd = dt.ct[((size_t)(L + 1) + lev) * Bz + b];
            }
            if constexpr (IDRV && !UPW) {
#pragma unroll
                for (int k = 0; k < KGPT; ++k) {
                    const int g = ty + k * KY;
                    if (g >= KG) continue;
                    const size_t gi = ((size_t)l * KG + g) * Bz + b;
                    lin[k] = dt.lam[gi];
                    linc[k] = anyc ? dt.lam[LGB + gi] : 0.0f;
                }
            }
            // clear: the up sweep's cotangents of taut and fracs, which
            // the down sweep adds to, loaded before any store of the step
            float pt[KGPT], pf[KGPT];
            if constexpr (!UPW && !CLOUDY) {
#pragma unroll
                for (int k = 0; k < KGPT; ++k) {
                    const int g = ty + k * KY;
                    if (g >= KG) continue;
                    const size_t gi = ((size_t)l * KG + g) * Bz + b;
                    pt[k] = gr.taut[gi];
                    pf[k] = gr.fracs[gi];
                }
            }
            auto row = [&](int off) {
                return reinterpret_cast<const float*>(s + off);
            };
            const float *tau_s = row(Sl::TAU), *fr_s = row(Sl::FR),
                        *rad_s = row(Sl::RAD), *play_s = row(Sl::PLAY),
                        *plev_s = row(Sl::PLEV);
            const int8_t* m_s = reinterpret_cast<const int8_t*>(s + Sl::MASK);
            // the per-g offsets are recomputed at each step from an opaque
            // g-lane (rtrn.cuh opaque), not held through the sweep
            const int gy = opaque(ty);
#pragma unroll
            for (int k = 0; k < KGPT; ++k) {
                const int g = gy + k * KY;
                if (g >= KG) continue;
                const int bd = ngb_s[g];
                lam[k] += wg_s[g] * cu;
                mu[k] += wg_s[g] * ccu;
                const size_t gi = ((size_t)l * KG + g) * Bz + b;
                const int gs = g * KX + tx, bs = bd * KX + tx;
                // compact: the up sweep's cotangents of taut and fracs
                if constexpr (!UPW && CLOUDY) {
                    pt[k] = gr.taut[gi];
                    pf[k] = gr.fracs[gi];
                }
                float rad = 0.0f, radc = 0.0f;
                if (UPW || l + 1 < L) {
                    rad = rad_s[gs];
                    radc = CLOUDY ? rad_s[KG * KX + gs] : rad;
                }
                const size_t bi = ((size_t)l * KNB + bd) * Bz + b;
                // idrv, up: the cotangent of the derivative leaving layer
                // l (the clear twin's folded in where it is the same) to
                // the scratch; down: the layer's transmittances' cotangents
                [[maybe_unused]] DdtStep ds{};
                [[maybe_unused]] float lt = 0.0f;
                if constexpr (IDRV && UPW) {
                    dd[k] += wg_s[g] * cd;
                    ddc[k] += wg_s[g] * ccd;
                    lt = anyc ? dd[k] : dd[k] + ddc[k];
                    dt.lam[gi] = lt;
                    if (anyc) dt.lam[LGB + gi] = ddc[k];
                }
                if constexpr (IDRV && !UPW) {
                    ds.ct_t = lin[k] * dd[k];
                    ds.ct_tc = anyc ? linc[k] * ddc[k] : 0.0f;
                }
                float ct_tau, ct_fr;
                step_bwd<CLOUDY, IDRV>(tau_s[gs], fr_s[gs], play_s[bs],
                                       plev_s[bs], secd_s[bs],
                                       CLOUDY ? (float)m_s[gs] : 0.0f, cw0,
                                       cw1, cly, twin, rad, radc, in.abi + bi,
                                       in.abl + bi, lam[k], mu[k], ct_tau,
                                       ct_fr, ctsec_s[gs], gp + gs, gw + gs,
                                       ds);
                if constexpr (IDRV && UPW) {
                    dd[k] = lt * ds.t;
                    ddc[k] = anyc ? ddc[k] * ds.tc : 0.0f;
                }
                if constexpr (IDRV && !UPW) {
                    const float pn = dd[k] * ds.t;
                    ddc[k] = anyc ? ddc[k] * ds.tc : pn;
                    dd[k] = pn;
                }
                if constexpr (UPW) {
                    gr.taut[gi] = ct_tau;
                    gr.fracs[gi] = ct_fr;
                } else {
                    gr.taut[gi] = pt[k] + ct_tau;
                    gr.fracs[gi] =
                        pf[k] + (FIRST ? ct_fr + ct_fr0[k] : ct_fr);
                }
            }
        }
        // the band-summed outputs of (layer l, band ty, column tx) and, in
        // lanes 0-1, of cw: the down sweep adds to the up sweep's, read
        // here so that the barriers below hide the loads
        const size_t bi = ((size_t)l * KNB + ty) * Bz + b;
        const size_t vi = ((size_t)lev * KNB + ty) * Bz + b;
        [[maybe_unused]] const size_t wi =
            ((size_t)l * 2 + (ty & 1)) * Bz + b;
        float part[NQS + 1] = {};   // + cw's
        if (!UPW && valid) {
            part[Q_PLAY] = gr.play[bi];
            if (lev > 0) part[Q_PLEV] = gr.plev[vi];
            if constexpr (CLOUDY) {
                part[Q_ABI] = gr.abi[bi];
                part[Q_ABL] = gr.abl[bi];
                if (ty < 2) part[NQS] = gr.cw[wi];
            }
        }
        // out = the sum, or (down sweep) the up sweep's plus the sum
        auto out = [&](float* p, float pv, float v, bool add) {
            *p = add ? pv + v : v;
        };
        __syncthreads();          // gp published; the slot of step j read
        float sq[NQ];
        band_sums<NQS>(gp, goff, sq);
        if constexpr (CLOUDY) {
            band_sums<2>(gw, goff, sq + Q_CW0);
            // cw: the band sums, then their sum in band order after the
            // barrier that frees the slot and gp_s
            bpart[ty * KX + tx] = sq[Q_CW0];
            bpart[(KNB + ty) * KX + tx] = sq[Q_CW1];
            if (j + 1 < 2 * L) {
                wait_step(j + 1);
                ballot_step(j + 1);
            }
            __syncthreads();
        }
        if (valid) {
            out(gr.play + bi, part[Q_PLAY], sq[Q_PLAY], !UPW);
            out(gr.plev + vi, part[Q_PLEV], sq[Q_PLEV], !UPW && lev > 0);
            if constexpr (CLOUDY) {
                out(gr.abi + bi, part[Q_ABI], sq[Q_ABI], !UPW);
                out(gr.abl + bi, part[Q_ABL], sq[Q_ABL], !UPW);
                if (ty < 2) {
                    float a = 0.0f;
#pragma unroll
                    for (int y = 0; y < KNB; ++y)
                        a += bpart[(ty * KNB + y) * KX + tx];
                    out(gr.cw + wi, part[NQS], a, !UPW);
                }
            }
        }
    };

    // ---- 3. up sweep in reverse: layer L-1 .. 0 ----
    for (int j = 0; j < L; ++j) step(std::true_type{}, std::false_type{}, j);

    // ---- 4. surface reflection in reverse ----
    // idrv: the d/dT seed fracs[0] x dplankbnd_dt takes the cotangent of
    // both derivatives at the surface; sd its per-g share of row 3's
    [[maybe_unused]] float sd[ND];
    {
        float* gp = gp_buf(L);
        if (valid) {
            const float cu = ct[(size_t)UP * (L + 1) * Bz + b];
            const float ccu = ct[(size_t)CLR_UP * (L + 1) * Bz + b];
            [[maybe_unused]] float cd0 = 0.0f, ccd0 = 0.0f;
            if constexpr (IDRV) {
                cd0 = dt.ct[b];
                ccd0 = dt.ct[(size_t)(L + 1) * Bz + b];
            }
#pragma unroll
            for (int k = 0; k < KGPT; ++k) {
                const int g = ty + k * KY;
                if (g >= KG) continue;
                const int bd = ngb_s[g];
                const float lam0 = lam[k] + wg_s[g] * cu;
                const float mu0 = mu[k] + wg_s[g] * ccu;
                const float fr0 = in.fracs[(size_t)g * Bz + b];
                const float pbnd = in.surf[((size_t)2 * KNB + bd) * Bz + b];
                const float reflect =
                    1.0f - in.surf[((size_t)KNB + bd) * Bz + b];
                const float d0 = rads[(size_t)g * Bz + b];
                const float dc0 = CLOUDY ? rads[2 * LGB + (size_t)g * Bz + b]
                                         : d0;
                const float ct_rad0 = lam0 + mu0;
                ct_fr0[k] = ct_rad0 * pbnd;
                gp[g * KX + tx] = -(lam0 * d0 + mu0 * dc0);
                gp[(KG + g) * KX + tx] = ct_rad0 * fr0;
                lam[k] = lam0 * reflect;
                mu[k] = mu0 * reflect;
                if constexpr (IDRV) {
                    const float dpl =
                        in.surf[((size_t)3 * KNB + bd) * Bz + b];
                    const float ctd0 = dd[k] + wg_s[g] * cd0
                                       + (ddc[k] + wg_s[g] * ccd0);
                    ct_fr0[k] += ctd0 * dpl;
                    sd[k] = ctd0 * fr0;
                    dd[k] = ddc[k] = fr0 * dpl;
                }
            }
        }
        __syncthreads();
        float sq[2];
        band_sums<2>(gp, goff, sq);
        if (valid) {
            gr.surf[((size_t)KNB + ty) * Bz + b] = sq[0];
            gr.surf[((size_t)2 * KNB + ty) * Bz + b] = sq[1];
        }
        __syncthreads();
        // idrv: row 3's cotangent, summed as row 2's
        if constexpr (IDRV) {
            if (valid) {
#pragma unroll
                for (int k = 0; k < KGPT; ++k) {
                    const int g = ty + k * KY;
                    if (g < KG) gp[g * KX + tx] = sd[k];
                }
            }
            __syncthreads();
            band_sums<1>(gp, goff, sq);
            if (valid) gr.surf[((size_t)3 * KNB + ty) * Bz + b] = sq[0];
            __syncthreads();
        }
    }

    // ---- 5. down sweep in reverse: layer 0 .. L-1 ----
    step(std::false_type{}, std::true_type{}, L);
    for (int j = L + 1; j < 2 * L; ++j)
        step(std::false_type{}, std::false_type{}, j);

    // ---- 6. the secant, summed over both sweeps (ctsec_s is final at
    // the last step's first barrier) ----
    float sq[1];
    band_sums<1>(ctsec_s, goff, sq);
    if (valid) gr.surf[(size_t)ty * Bz + b] = sq[0];
}

template <bool CLOUDY>
__global__ void __launch_bounds__(KT, BLOCKS_PER_SM)
rt_bwd_kernel(Inputs in, const int* __restrict__ ngb,
              const float* __restrict__ wg, const float* __restrict__ ct,
              const float* __restrict__ rads, Grads gr) {
    rt_bwd_body<CLOUDY, false>(in, ngb, wg, ct, rads, gr, Ddt{});
}

// K6 with the d/dT sweep's adjoint (idrv=1 and a cotangent of duflx_dt
// or duflxc_dt), clear sky alone: one block per SM in the launch bounds,
// two fit (120 registers).
template <bool CLOUDY>
__global__ void __launch_bounds__(KT, 1)
rt_bwd_ddt_kernel(Inputs in, const int* __restrict__ ngb,
                  const float* __restrict__ wg, const float* __restrict__ ct,
                  const float* __restrict__ rads, Grads gr, Ddt dt) {
    rt_bwd_body<CLOUDY, true>(in, ngb, wg, ct, rads, gr, dt);
}

template <bool CLOUDY, bool IDRV>
auto bwd_kernel() {
    if constexpr (IDRV)
        return rt_bwd_ddt_kernel<CLOUDY>;
    else
        return rt_bwd_kernel<CLOUDY>;
}

// the shared memory attributes of K6, set once per process
template <bool CLOUDY, bool IDRV>
cudaError_t prepare_bwd() {
    static const cudaError_t e =
        tile_smem(bwd_kernel<CLOUDY, IDRV>(), BwdLayout<CLOUDY>::BYTES);
    return e;
}

// K6, with the d/dT sweep's adjoint where dt.ct is given (clear sky;
// compact's: rtrn_bwd_g.cu)
template <bool CLOUDY>
cudaError_t launch_bwd(const Inputs& in, const int* ngb, const float* wg,
                       const float* ct, const float* rads, const Grads& gr,
                       const Ddt& dt, cudaStream_t s) {
    const dim3 block(KX, KY);
    const dim3 grid((in.B + KX - 1) / KX);
    if constexpr (CLOUDY) {
        if (dt.ct) return cudaErrorInvalidValue;
    } else if (dt.ct) {
        const cudaError_t e = prepare_bwd<CLOUDY, true>();
        if (e != cudaSuccess) return e;
        rt_bwd_ddt_kernel<CLOUDY>
            <<<grid, block, BwdLayout<CLOUDY>::BYTES, s>>>(in, ngb, wg, ct,
                                                           rads, gr, dt);
        return cudaGetLastError();
    }
    const cudaError_t e = prepare_bwd<CLOUDY, false>();
    if (e != cudaSuccess) return e;
    rt_bwd_kernel<CLOUDY><<<grid, block, BwdLayout<CLOUDY>::BYTES, s>>>(
        in, ngb, wg, ct, rads, gr);
    return cudaGetLastError();
}

template <bool CLOUDY, bool IDRV>
cudaError_t info_bwd(int* out) {
    cudaError_t e = prepare_bwd<CLOUDY, IDRV>();
    if (e != cudaSuccess) return e;
    return tile_info(bwd_kernel<CLOUDY, IDRV>(), BwdLayout<CLOUDY>::BYTES,
                     RING, out);
}

int bwd_entry(const Inputs& in, const int* ngb, const float* wg,
              const float* ct, const float* rads, const Grads& gr,
              const Ddt& dt, int cloudy, void* stream) {
    if (in.L <= 0 || in.B <= 0) return (int)cudaGetLastError();
    if (!rads || !ct || (dt.ct && !dt.lam)
        || (cloudy && (!in.mask || !in.cw || !in.abi || !in.abl || !gr.cw
                       || !gr.abi || !gr.abl)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(cloudy ? launch_bwd<true>(in, ngb, wg, ct, rads, gr, dt, s)
                        : launch_bwd<false>(in, ngb, wg, ct, rads, gr, dt,
                                            s));
}

}  // namespace

// Inputs as rrtm_rt; ct (4, L+1, B) flux cotangents; rads (4 or 2, L,
// 140, B) the radiances K1 kept in the same step (rrtm_rt with rads);
// outputs ct_taut, ct_fracs (L, 140, B), ct_play (L, 16, B), ct_plev
// (L+1, 16, B), ct_surf (3, 16, B), and (cloudy) ct_cw (L, 2, B), ct_abi,
// ct_abl (L, 16, B).
RRTM_API int rrtm_rt_bwd(const float* taut, const float* fracs,
                         const float* play, const float* plev,
                         const float* surf, const int* ngb, const float* wg,
                         const int8_t* mask, const float* cw,
                         const float* abi, const float* abl, const float* ct,
                         const float* rads, float* ct_taut, float* ct_fracs,
                         float* ct_play, float* ct_plev, float* ct_surf,
                         float* ct_cw, float* ct_abi, float* ct_abl, int L,
                         int B, int cloudy, void* stream) {
    const Inputs in{taut, fracs, play, plev, surf, mask, cw, abi, abl, L, B};
    const Grads gr{ct_taut, ct_fracs, ct_play, ct_plev, ct_surf, ct_cw,
                   ct_abi, ct_abl};
    return bwd_entry(in, ngb, wg, ct, rads, gr, Ddt{}, cloudy, stream);
}

// rrtm_rt_bwd at idrv=1 with the d/dT sweep's adjoint, clear sky (cloudy
// 0; compact: rrtm_rt_bwd_g_ddt): surf and ct_surf (4, 16, B), the fourth
// row dplankbnd_dt and its cotangent; ct_ddt (2, L+1, B) the cotangents
// of duflx_dt and duflxc_dt; lam the scratch of (L, 140, B) floats
// (rtrn.cuh Ddt).
RRTM_API int rrtm_rt_bwd_ddt(const float* taut, const float* fracs,
                             const float* play, const float* plev,
                             const float* surf, const int* ngb,
                             const float* wg, const int8_t* mask,
                             const float* cw, const float* abi,
                             const float* abl, const float* ct,
                             const float* rads, float* ct_taut,
                             float* ct_fracs, float* ct_play, float* ct_plev,
                             float* ct_surf, float* ct_cw, float* ct_abi,
                             float* ct_abl, const float* ct_ddt, float* lam,
                             int L, int B, int cloudy, void* stream) {
    if (!ct_ddt) return (int)cudaErrorInvalidValue;
    const Inputs in{taut, fracs, play, plev, surf, mask, cw, abi, abl, L, B};
    const Grads gr{ct_taut, ct_fracs, ct_play, ct_plev, ct_surf, ct_cw,
                   ct_abi, ct_abl};
    return bwd_entry(in, ngb, wg, ct, rads, gr, Ddt{ct_ddt, lam}, cloudy,
                     stream);
}

// The launch configuration of K6, clear or compact (cloudy): out[0..7]
// as rrtm_rt_info's (rtrn.cuh tile_info).
RRTM_API int rrtm_rt_bwd_info(int cloudy, int* out) {
    return (int)(cloudy ? info_bwd<true, false>(out)
                        : info_bwd<false, false>(out));
}

// The same of rrtm_rt_bwd_ddt's instantiation (clear sky: cloudy 0).
RRTM_API int rrtm_rt_bwd_ddt_info(int cloudy, int* out) {
    return (int)(cloudy ? cudaErrorInvalidValue : info_bwd<false, true>(out));
}
