// K6 in the maxrand mode: the adjoint of K1's maximum-random overlap
// sweep (icld 2/3; idrv = 0, or idrv = 1 without a cotangent of the
// d/dT outputs): flux cotangents (4, L+1, B) -> cotangents of taut,
// fracs (L, 140, B), planklay (L, 16, B), planklev (L+1, 16, B), the
// surface rows (3, 16, B), the per-band cloud od taucb (L, 16, B) and
// the overlap rows (L, 16, B): R_CLDF and the 12 factor rows, zeros in
// the four flag rows.
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
// forward values each reverse step needs, the radiances and sub-streams
// entering its layer, come from K1's gradient-step launch (SAVE,
// rtrn_kernel.cuh: rads (10, L, 140, B), the sub-streams written only
// where this kernel reads them); the factors of each step are
// recomputed from taut as K1 forms them.  The discrete gates (cloudy
// layer, restart flags, iclddn, the od branches) carry no gradient; at
// od = secd * taut = 0 the maximum of the plain version passes half the
// gradient, as torch.maximum does at a tie.
//
// Design: a simple kernel.  A block holds 32 columns x 8 g-lanes (256
// threads); lane y takes two whole bands (PAIR, band_lanes.cuh, 16-20
// g-points), so each band's sums (planklay, planklev, taucb, the surface
// rows, the secant) stay in one thread, in ascending g.  The five carries of every (g,
// column) live in shared memory (89.6 KB).  The 7 per-layer sums over g
// of the overlap rows' cotangents (R_CLDF and the sweep's six factors)
// go through shared memory: each lane's partial over its g in order,
// then the 8 lanes in lane order, double-buffered (one block barrier a
// step).  Per (layer, g, column) the kernel reads taut and fracs twice,
// the radiance and its clear twin entering the layer and, in a cloudy
// layer that does not restart the sub-streams, the three sub-streams,
// and writes ct_taut and ct_fracs twice (read-add in the down sweep).
// No atomics on floats: two runs are bitwise equal.
#include "band_lanes.cuh"
#include "rtrn.cuh"

namespace {

using namespace rrtm::rt;

constexpr int NCAR = 5;                 // lam, mu, cr, kr, rr cotangents
constexpr int NPART = 7;                // R_CLDF and the six factors

// rows of the saved state (rtrn_kernel.cuh SAVE, maxrand)
enum Saved { S_D = 0, S_U = 1, S_DC = 2, S_UC = 3, S_SUB_DN = 4,
             S_SUB_UP = 7 };

struct MrLayout {
    static constexpr int CAR = 0;                          // (5, KG, MX)
    static constexpr int PART = CAR + NCAR * KG * MX * 4;  // (2, 7, MY, MX)
    static constexpr int NGB = PART + 2 * NPART * MY * MX * 4;
    static constexpr int WG = NGB + KG * 4;
    static constexpr int GOFF = WG + KG * 4;                   // (KNB + 1)
    static constexpr int BYTES = align16(GOFF + (KNB + 1) * 4);
};
constexpr int MR_BLOCKS_PER_SM = 2;
static_assert(MR_BLOCKS_PER_SM * (MrLayout::BYTES + SMEM_RESERVED)
                  <= SMEM_SM,
              "two maxrand K6 blocks fit an SM");

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
// the step's outputs on entry and of its inputs on exit.
__device__ __forceinline__ StepGrads mr_step_bwd(
        float tau, float fr, float bl, float pl, float secd, float tcb,
        float cf, bool cly, bool twin, bool ist, const float* fac,
        float rad, float radc, float cr, float kr, float rr, Car& k) {
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

__global__ void __launch_bounds__(MT, MR_BLOCKS_PER_SM)
rt_bwd_mr_kernel(Inputs in, const int* __restrict__ ngb,
                 const float* __restrict__ wg, const float* __restrict__ ct,
                 const float* __restrict__ rads, MrGrads gr) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* car_s = reinterpret_cast<float*>(smem + MrLayout::CAR);
    float* part_s = reinterpret_cast<float*>(smem + MrLayout::PART);
    int* ngb_s = reinterpret_cast<int*>(smem + MrLayout::NGB);
    float* wg_s = reinterpret_cast<float*>(smem + MrLayout::WG);
    int* goff = reinterpret_cast<int*>(smem + MrLayout::GOFF);

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * MX + tx;
    const int L = in.L, B = in.B;
    const size_t Bz = B;
    const int bt = blockIdx.x * MX;
    const int nvalid = min(MX, B - bt);
    const bool valid = tx < nvalid;
    const int b = bt + tx;
    for (int i = tid; i < KG; i += MT) {
        ngb_s[i] = ngb[i];
        wg_s[i] = wg[i];
        if (i == 0 || ngb[i] != ngb[i - 1]) goff[ngb[i]] = i;
    }
    if (tid == 0) goff[KNB] = KG;
    for (int i = tid; i < NCAR * KG * MX; i += MT) car_s[i] = 0.0f;
    __syncthreads();

    const size_t LGB = (size_t)L * KG * Bz;
    const int bands[2] = {PAIR[ty][0], PAIR[ty][1]};
    float sec[2], ct_sec[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
        sec[h] = valid ? in.surf[(size_t)bands[h] * Bz + b] : 0.0f;
    // the anyc twin flag of the up sweep: cloud anywhere in the column
    const bool anyc = valid && in.cld[(size_t)R_ICLDDN * Bz + b] > 0.0f;
    auto car = [&](int q, int g) -> float& {
        return car_s[(q * KG + g) * MX + tx];
    };

    // one reverse step: layer l of the up (UPW) or down sweep; j counts
    // the steps (the partials' buffer)
    auto step = [&](auto upward, int l, int j) {
        constexpr bool UPW = decltype(upward)::value;
        const int lev = UPW ? l + 1 : l;
        float* part = part_s + (j & 1) * NPART * MY * MX;
        float p[NPART] = {};
        if (valid) {
            const float* rw = in.cld + (size_t)l * NROW * Bz + b;
            const float cf = rw[R_CLDF * Bz];
            const bool cly = cf >= CLOUD_GATE;
            const bool ist = rw[(UPW ? R_IST_UP : R_IST_DN) * Bz] > 0.0f;
            const bool twin = UPW ? anyc : rw[R_ICLDDN * Bz] > 0.0f;
            float fac[6];
#pragma unroll
            for (int i = 0; i < 6; ++i)
                fac[i] = rw[((UPW ? R_UP : R_DN) + i) * Bz];
            const float cu =
                ct[((size_t)(UPW ? UP : DOWN) * (L + 1) + lev) * Bz + b];
            const float ccu =
                ct[((size_t)(UPW ? CLR_UP : CLR_DOWN) * (L + 1) + lev) * Bz
                   + b];
            // the state entering the layer: up, U and Uc at l; down, D
            // and Dc at level l + 1 (none above the top)
            const bool has_in = UPW || l + 1 < L;
            const size_t in_off = UPW ? (size_t)l * KG * Bz
                                      : (size_t)(l + 1) * KG * Bz;
            const float* r_in = rads + (UPW ? S_U : S_D) * LGB + in_off;
            const float* rc_in = rads + (UPW ? S_UC : S_DC) * LGB + in_off;
            const float* sub =
                rads + (UPW ? S_SUB_UP : S_SUB_DN) * LGB + (size_t)l * KG * Bz;
            const bool read_sub = cly && !ist;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int bd = bands[h];
                const size_t bi = ((size_t)l * KNB + bd) * Bz + b;
                const size_t vi = ((size_t)lev * KNB + bd) * Bz + b;
                const float bl = in.play[bi];
                const float pl = in.plev[vi];
                const float tcb = in.taucb[bi];
                float s_bl = 0.0f, s_pl = 0.0f, s_tcb = 0.0f;
                for (int g = goff[bd]; g < goff[bd + 1]; ++g) {
                    const size_t gi = (size_t)g * Bz + b;
                    const size_t li = (size_t)l * KG * Bz + gi;
                    Car k{car(0, g) + wg_s[g] * cu, car(1, g) + wg_s[g] * ccu,
                          car(2, g), car(3, g), car(4, g)};
                    const float rad = has_in ? r_in[gi] : 0.0f;
                    const float radc = has_in ? rc_in[gi] : 0.0f;
                    float cr = 0.0f, kr = 0.0f, rr = 0.0f;
                    if (read_sub) {
                        cr = sub[gi];
                        kr = sub[LGB + gi];
                        rr = sub[2 * LGB + gi];
                    }
                    const StepGrads o = mr_step_bwd(
                        in.taut[li], in.fracs[li], bl, pl, sec[h], tcb, cf,
                        cly, twin, ist, fac, rad, radc, cr, kr, rr, k);
                    car(0, g) = k.lam;
                    car(1, g) = k.mu;
                    car(2, g) = k.cr;
                    car(3, g) = k.kr;
                    car(4, g) = k.rr;
                    if (UPW) {
                        gr.taut[li] = o.tau;
                        gr.fracs[li] = o.fr;
                    } else {
                        gr.taut[li] = gr.taut[li] + o.tau;
                        gr.fracs[li] = gr.fracs[li] + o.fr;
                    }
                    s_bl += o.bl;
                    s_pl += o.pl;
                    s_tcb += o.tcb;
                    ct_sec[h] += o.secd;
                    p[0] += o.c;
#pragma unroll
                    for (int i = 0; i < 6; ++i) p[1 + i] += o.fac[i];
                }
                if (UPW) {
                    gr.play[bi] = s_bl;
                    gr.plev[vi] = s_pl;
                    gr.taucb[bi] = s_tcb;
                } else {
                    gr.play[bi] = gr.play[bi] + s_bl;
                    gr.plev[vi] = lev > 0 ? gr.plev[vi] + s_pl : s_pl;
                    gr.taucb[bi] = gr.taucb[bi] + s_tcb;
                }
            }
        }
#pragma unroll
        for (int r = 0; r < NPART; ++r) part[(r * MY + ty) * MX + tx] = p[r];
        __syncthreads();
        // the overlap rows of layer l: the lanes' partials summed in lane
        // order; R_CLDF adds the down sweep's to the up sweep's; the up
        // sweep also zeroes the four flag rows
        for (int i = tid; i < (UPW ? NPART + 3 : NPART) * MX; i += MT) {
            const int r = i / MX, col = i - r * MX;
            if (col >= nvalid) continue;
            float* o = gr.rows + (size_t)l * NROW * Bz + bt + col;
            if (r >= NPART) {
                o[(size_t)(R_IST_UP + r - NPART) * Bz] = 0.0f;
                continue;
            }
            float a = 0.0f;
#pragma unroll
            for (int y = 0; y < MY; ++y) a += part[(r * MY + y) * MX + col];
            if (r == 0)
                o[R_CLDF * Bz] = UPW ? a : o[R_CLDF * Bz] + a;
            else
                o[(size_t)((UPW ? R_UP : R_DN) + r - 1) * Bz] = a;
        }
    };

    // ---- up sweep in reverse: layer L-1 .. 0 ----
    for (int j = 0; j < L; ++j) step(std::true_type{}, L - 1 - j, j);

    // ---- surface reflection in reverse; the sub-streams' cotangents end
    // here (the up sweep starts them at zero) ----
    if (valid) {
        const float cu = ct[(size_t)UP * (L + 1) * Bz + b];
        const float ccu = ct[(size_t)CLR_UP * (L + 1) * Bz + b];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int bd = bands[h];
            const float pbnd = in.surf[((size_t)2 * KNB + bd) * Bz + b];
            const float reflect = 1.0f - in.surf[((size_t)KNB + bd) * Bz + b];
            float s_em = 0.0f, s_pb = 0.0f;
            for (int g = goff[bd]; g < goff[bd + 1]; ++g) {
                const size_t gi = (size_t)g * Bz + b;
                const float lam0 = car(0, g) + wg_s[g] * cu;
                const float mu0 = car(1, g) + wg_s[g] * ccu;
                const float d0 = rads[S_D * LGB + gi];
                const float dc0 = rads[S_DC * LGB + gi];
                const float ct_rad0 = lam0 + mu0;
                gr.fracs[gi] = gr.fracs[gi] + ct_rad0 * pbnd;
                s_em += -(lam0 * d0 + mu0 * dc0);
                s_pb += ct_rad0 * in.fracs[gi];
                car(0, g) = lam0 * reflect;
                car(1, g) = mu0 * reflect;
                car(2, g) = car(3, g) = car(4, g) = 0.0f;
            }
            gr.surf[((size_t)KNB + bd) * Bz + b] = s_em;
            gr.surf[((size_t)2 * KNB + bd) * Bz + b] = s_pb;
        }
    }

    // ---- down sweep in reverse: layer 0 .. L-1 ----
    for (int j = L; j < 2 * L; ++j) step(std::false_type{}, j - L, j);

    // ---- the secants, summed over both sweeps ----
    if (valid) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
            gr.surf[(size_t)bands[h] * Bz + b] = ct_sec[h];
    }
}

// the shared memory attributes of the kernel, set once per process
cudaError_t prepare_bwd_mr() {
    static const cudaError_t e = [] {
        cudaError_t e = cudaFuncSetAttribute(
            rt_bwd_mr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            MrLayout::BYTES);
        if (e != cudaSuccess) return e;
        return cudaFuncSetAttribute(
            rt_bwd_mr_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
    }();
    return e;
}

}  // namespace

// Inputs as rrtm_rt's in the maxrand mode (surf (3, 16, B); rows the
// overlap rows (L, 16, B), taucb (L, 16, B)); ct (4, L+1, B) flux
// cotangents; rads (10, L, 140, B) the state K1 kept in the same step
// (rrtm_rt with rads, maxrand) -> ct_taut, ct_fracs (L, 140, B), ct_play
// (L, 16, B), ct_plev (L+1, 16, B), ct_surf (3, 16, B), ct_rows (L, 16,
// B), ct_taucb (L, 16, B).
RRTM_API int rrtm_rt_bwd_mr(const float* taut, const float* fracs,
                            const float* play, const float* plev,
                            const float* surf, const float* rows,
                            const float* taucb, const int* ngb,
                            const float* wg, const float* ct,
                            const float* rads, float* ct_taut,
                            float* ct_fracs, float* ct_play, float* ct_plev,
                            float* ct_surf, float* ct_rows, float* ct_taucb,
                            int L, int B, void* stream) {
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    if (!rads || !rows || !taucb) return (int)cudaErrorInvalidValue;
    cudaError_t e = prepare_bwd_mr();
    if (e != cudaSuccess) return (int)e;
    Inputs in{taut, fracs, play, plev, surf, nullptr, nullptr, nullptr,
              nullptr, L, B};
    in.cld = rows;
    in.taucb = taucb;
    const MrGrads gr{ct_taut, ct_fracs, ct_play, ct_plev, ct_surf, ct_rows,
                     ct_taucb};
    const dim3 block(MX, MY);
    const dim3 grid((B + MX - 1) / MX);
    rt_bwd_mr_kernel<<<grid, block, MrLayout::BYTES, (cudaStream_t)stream>>>(
        in, ngb, wg, ct, rads, gr);
    return (int)cudaGetLastError();
}

// Its launch configuration: out[0..7] = registers per thread, local
// memory bytes per thread, static and dynamic shared memory per block,
// blocks per SM, 0 (no ring), threads and columns per block.
RRTM_API int rrtm_rt_bwd_mr_info(int* out) {
    cudaError_t e = prepare_bwd_mr();
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, rt_bwd_mr_kernel);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, rt_bwd_mr_kernel, MT, MrLayout::BYTES);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = MrLayout::BYTES;
    out[4] = blocks;
    out[5] = 0;
    out[6] = MT;
    out[7] = MX;
    return (int)cudaSuccess;
}
