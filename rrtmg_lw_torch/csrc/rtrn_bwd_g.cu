// K6 in the banded, fused and cldf-odcld modes: the adjoint of K1's
// random-overlap sweep of per-band clouds (banded, icld=1) and of McICA
// per-g clouds (fused: cldprmc inline, inflag=2; cldf-odcld: the per-g
// cloud od given, inflag=0), at idrv = 0 or at idrv = 1 without a
// cotangent of the d/dT outputs: flux cotangents (4, L+1, B) ->
// cotangents of taut, fracs (L, 140, B), planklay (L, 16, B), planklev
// (L+1, 16, B), the surface rows (3, 16, B) and the mode's cloud inputs:
//   banded:     cldfrac (L, B), the per-band cloud od taucb (L, 16, B);
//   cldf-odcld: cldf, odcld (L, 144, B);
//   fused:      cldf, ciwp, clwp, tauc (L, 144, B), abi, abl (L, 16, B);
// the pad rows 140-143 of every (L, 144, B) cotangent zero.
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
// B), D, U and their clear twins); the factors of each step are
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
// cotangents once, twice in a cloudy layer (outside one they are zero:
// the down sweep leaves them).  Each input read once and each output written once, the bytes
// are ~5.1 GB at B=16384, L=60 banded (1.5 ms at 3.35 TB/s), ~1.1 GB more
// in cldf-odcld and ~2.3 GB more in fused; against that a few tens of
// flops and 1-3 expf per element and sweep.
//
// Design: a simple kernel, on K6 maxrand's tile (band_lanes.cuh): 32
// columns x 8 g-lanes, lane y takes the two bands PAIR[y], so each band's
// sums (planklay, planklev, taucb or abi and abl, the surface rows, the
// secant) stay in one thread in ascending g.  The two carries of every
// (g, column) live in shared memory (35.8 KB).  A first pass marks the
// cloudy layers of each column in shared memory (L bytes a column; the
// per-g modes read cldf once more for it).  Banded's cloud-fraction
// cotangent is a sum over the 140 g-points: each lane's partial in its g
// order, then the 8 lanes in lane order through shared memory,
// double-buffered (one block barrier a step); the per-g modes need no
// barrier in the sweeps.  No atomics on floats: two runs are bitwise
// equal.
#include "band_lanes.cuh"
#include "rtrn.cuh"

namespace {

using namespace rrtm::rt;

constexpr int NCLD = 6;                 // cloud inputs of a mode, at most
constexpr int G_BLOCKS_PER_SM = 2;

// rows of the saved radiances (rtrn_kernel.cuh SAVE)
enum Saved { S_D = 0, S_U = 1, S_DC = 2, S_UC = 3 };

struct GLayout {
    static constexpr int CAR = 0;                          // (2, KG, MX)
    static constexpr int PART = CAR + 2 * KG * MX * 4;     // (2, MY, MX)
    static constexpr int NGB = PART + 2 * MY * MX * 4;
    static constexpr int WG = NGB + KG * 4;
    static constexpr int GOFF = WG + KG * 4;               // (KNB + 1)
    static constexpr int CLY = align16(GOFF + (KNB + 1) * 4);  // (L, MX)
    static int bytes(int L) { return CLY + align16(L * MX); }
};

// The cloud inputs of each mode, in the order of rtrn_cuda.CLOUD_INPUTS:
// banded: c[0] cldfrac (L, B), c[1] taucb (L, 16, B); cldf-odcld: c[0]
// cldf, c[1] odcld (L, 144, B); fused: c[0..3] cldf, ciwp, clwp, tauc
// (L, 144, B), c[4], c[5] abi, abl (L, 16, B).  The cotangents likewise.
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
// band's taucb; cldf-odcld: odcld; fused: tauc) and, fused, of the water
// paths and the band's coefficients.
struct StepGrads {
    float tau, fr, bl, pl, secd, cf, tauc, ciwp, clwp, abi, abl;
};

// Reverse of one advance() of a layer for one (column, g), with K1's
// staged_step in MODE: tau, fr the g's taut and fracs, bl, pl the band's
// Planck rows, secd its secant; cf the cloud fraction (banded: the
// layer's; else the g's), tauc the cloud od (banded: the band's taucb;
// cldf-odcld: odcld; fused: tauc), ciwp, clwp the g's water paths and
// ai_b, al_b the band's coefficients (fused); cly the layer's flag, twin
// the clear twin's; rad, radc the radiance and clear twin entering the
// layer.  lam, mu hold the cotangents of the step's outputs on entry and
// of its inputs on exit.
template <int MODE>
__device__ __forceinline__ StepGrads g_step_bwd(
        float tau, float fr, float bl, float pl, float secd, float cf,
        float tauc, float ciwp, float clwp, float ai_b, float al_b,
        bool cly, bool twin, float rad, float radc, float& lam, float& mu) {
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
            if constexpr (MODE == FUSED) {
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
            o.secd += ct_odce * odcld;
            const float ct_odcld = ct_odce * secd;
            if (MODE == FUSED && active) {
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

template <int MODE>
__global__ void __launch_bounds__(MT, G_BLOCKS_PER_SM)
rt_bwd_g_kernel(Inputs in, Clouds cl, const int* __restrict__ ngb,
                const float* __restrict__ wg, const float* __restrict__ ct,
                const float* __restrict__ rads, GGrads gr) {
    using Lo = GLayout;
    constexpr bool BND = MODE == BANDED;
    constexpr bool FSD = MODE == FUSED;
    extern __shared__ __align__(16) unsigned char smem[];
    float* car_s = reinterpret_cast<float*>(smem + Lo::CAR);
    float* part_s = reinterpret_cast<float*>(smem + Lo::PART);
    int* ngb_s = reinterpret_cast<int*>(smem + Lo::NGB);
    float* wg_s = reinterpret_cast<float*>(smem + Lo::WG);
    int* goff = reinterpret_cast<int*>(smem + Lo::GOFF);
    unsigned char* cly_s = smem + Lo::CLY;

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
    for (int i = tid; i < 2 * KG * MX; i += MT) car_s[i] = 0.0f;
    for (int i = tid; i < L * MX; i += MT) cly_s[i] = 0;
    __syncthreads();

    // ---- 1. the cloudy layers of each column (every lane that finds a
    // cloudy g-point writes the same 1) ----
    if (valid) {
        if constexpr (BND) {
            for (int l = ty; l < L; l += MY)
                if (cl.c[0][(size_t)l * Bz + b] >= CLOUD_GATE)
                    cly_s[l * MX + tx] = 1;
        } else {
            for (int l = 0; l < L; ++l) {
                const float* f = cl.c[0] + (size_t)l * rrtm::NGPT_PAD * Bz + b;
                bool any = false;
                for (int g = ty; g < KG; g += MY) any |= f[g * Bz] >= 0.5f;
                if (any) cly_s[l * MX + tx] = 1;
            }
        }
    }
    __syncthreads();
    int hi = -1;                            // the highest cloudy layer
    for (int l = L - 1; l >= 0 && hi < 0; --l)
        if (cly_s[l * MX + tx]) hi = l;
    const bool anyc = hi >= 0;

    const size_t LGB = (size_t)L * KG * Bz;
    const int bands[2] = {PAIR[ty][0], PAIR[ty][1]};
    float sec[2], ct_sec[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
        sec[h] = valid ? in.surf[(size_t)bands[h] * Bz + b] : 0.0f;
    auto car = [&](int q, int g) -> float& {
        return car_s[(q * KG + g) * MX + tx];
    };
    // out = v (up sweep) or out + v (down sweep)
    auto put = [](float* p, float v, bool add) { *p = add ? *p + v : v; };

    // one reverse step: layer l of the up (UPW) or down sweep; j counts
    // the steps (banded's partials' buffer)
    auto step = [&](auto upward, int l, int j) {
        constexpr bool UPW = decltype(upward)::value;
        const int lev = UPW ? l + 1 : l;
        float p = 0.0f;                     // banded: the lane's ct_cldfrac
        if (valid) {
            const bool cly = cly_s[l * MX + tx] != 0;
            const bool twin = UPW ? anyc : l <= hi;
            const float cu =
                ct[((size_t)(UPW ? UP : DOWN) * (L + 1) + lev) * Bz + b];
            const float ccu =
                ct[((size_t)(UPW ? CLR_UP : CLR_DOWN) * (L + 1) + lev) * Bz
                   + b];
            // the radiances entering the layer: up, U and Uc at l; down, D
            // and Dc at level l + 1 (none above the top)
            const bool has_in = UPW || l + 1 < L;
            const size_t in_off = UPW ? (size_t)l * KG * Bz
                                      : (size_t)(l + 1) * KG * Bz;
            const float* r_in = rads + (UPW ? S_U : S_D) * LGB + in_off;
            const float* rc_in = rads + (UPW ? S_UC : S_DC) * LGB + in_off;
            const float cfl = BND && cly ? cl.c[0][(size_t)l * Bz + b] : 0.0f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int bd = bands[h];
                const size_t bi = ((size_t)l * KNB + bd) * Bz + b;
                const size_t vi = ((size_t)lev * KNB + bd) * Bz + b;
                const float bl = in.play[bi];
                const float pl = in.plev[vi];
                float tcb = 0.0f, ai_b = 0.0f, al_b = 0.0f;
                if (BND && cly) tcb = cl.c[1][bi];
                if (FSD && cly) {
                    ai_b = cl.c[4][bi];
                    al_b = cl.c[5][bi];
                }
                float s_bl = 0.0f, s_pl = 0.0f, s_c0 = 0.0f, s_c1 = 0.0f;
                for (int g = goff[bd]; g < goff[bd + 1]; ++g) {
                    const size_t gi = (size_t)g * Bz + b;
                    const size_t li = (size_t)l * KG * Bz + gi;
                    const size_t pi = ((size_t)l * rrtm::NGPT_PAD + g) * Bz + b;
                    float lam = car(0, g) + wg_s[g] * cu;
                    float mu = car(1, g) + wg_s[g] * ccu;
                    const float rad = has_in ? r_in[gi] : 0.0f;
                    const float radc = has_in ? rc_in[gi] : 0.0f;
                    // the g's cloud inputs, read where the step uses them
                    float cf = cfl, tauc = tcb, ciwp = 0.0f, clwp = 0.0f;
                    if (!BND && cly) {
                        cf = cl.c[0][pi];
                        if (cf >= 0.5f) {
                            if constexpr (FSD) {
                                ciwp = cl.c[1][pi];
                                clwp = cl.c[2][pi];
                                tauc = cl.c[3][pi];
                            } else {
                                tauc = cl.c[1][pi];
                            }
                        }
                    }
                    const StepGrads o = g_step_bwd<MODE>(
                        in.taut[li], in.fracs[li], bl, pl, sec[h], cf, tauc,
                        ciwp, clwp, ai_b, al_b, cly, twin, rad, radc, lam,
                        mu);
                    car(0, g) = lam;
                    car(1, g) = mu;
                    put(gr.taut + li, o.tau, !UPW);
                    put(gr.fracs + li, o.fr, !UPW);
                    s_bl += o.bl;
                    s_pl += o.pl;
                    ct_sec[h] += o.secd;
                    if constexpr (BND) {
                        p += o.cf;
                        s_c0 += o.tauc;
                    } else if (UPW || cly) {
                        put(gr.c[0] + pi, o.cf, !UPW);
                        if constexpr (FSD) {
                            put(gr.c[1] + pi, o.ciwp, !UPW);
                            put(gr.c[2] + pi, o.clwp, !UPW);
                            put(gr.c[3] + pi, o.tauc, !UPW);
                            s_c0 += o.abi;
                            s_c1 += o.abl;
                        } else {
                            put(gr.c[1] + pi, o.tauc, !UPW);
                        }
                    }
                }
                put(gr.play + bi, s_bl, !UPW);
                put(gr.plev + vi, s_pl, !UPW && lev > 0);
                // the cloud inputs' cotangents are zero outside a cloudy
                // layer: the up sweep wrote them, the down sweep adds
                // only in a cloudy one
                if (UPW || cly) {
                    if constexpr (BND) put(gr.c[1] + bi, s_c0, !UPW);
                    if constexpr (FSD) {
                        put(gr.c[4] + bi, s_c0, !UPW);
                        put(gr.c[5] + bi, s_c1, !UPW);
                    }
                }
            }
            // the pad rows 140-143 of the per-g cotangents
            if (!BND && UPW && ty < rrtm::NGPT_PAD - KG) {
                const size_t pi =
                    ((size_t)l * rrtm::NGPT_PAD + KG + ty) * Bz + b;
#pragma unroll
                for (int q = 0; q < (FSD ? 4 : 2); ++q) gr.c[q][pi] = 0.0f;
            }
        }
        if constexpr (BND) {
            // the cloud fraction's cotangent of layer l: the lanes'
            // partials summed in lane order
            float* part = part_s + (j & 1) * MY * MX;
            part[ty * MX + tx] = p;
            __syncthreads();
            if (tid < nvalid) {
                float a = 0.0f;
#pragma unroll
                for (int y = 0; y < MY; ++y) a += part[y * MX + tid];
                put(gr.c[0] + (size_t)l * Bz + bt + tid, a, !UPW);
            }
        }
    };

    // ---- 2. up sweep in reverse: layer L-1 .. 0 ----
    for (int j = 0; j < L; ++j) step(std::true_type{}, L - 1 - j, j);

    // ---- 3. surface reflection in reverse ----
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
            }
            gr.surf[((size_t)KNB + bd) * Bz + b] = s_em;
            gr.surf[((size_t)2 * KNB + bd) * Bz + b] = s_pb;
        }
    }

    // ---- 4. down sweep in reverse: layer 0 .. L-1 ----
    for (int j = L; j < 2 * L; ++j) step(std::false_type{}, j - L, j);

    // ---- 5. the secants, summed over both sweeps ----
    if (valid) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
            gr.surf[(size_t)bands[h] * Bz + b] = ct_sec[h];
    }
}

// the shared memory attributes of an instantiation, set once per process
// (at the largest dynamic shared memory a block can take: it grows with L)
template <int MODE>
cudaError_t prepare_bwd_g() {
    static const cudaError_t e =
        tile_smem(rt_bwd_g_kernel<MODE>, SMEM_SM - SMEM_RESERVED);
    return e;
}

template <int MODE>
cudaError_t launch_bwd_g(const Inputs& in, const Clouds& cl, const int* ngb,
                         const float* wg, const float* ct, const float* rads,
                         const GGrads& gr, cudaStream_t s) {
    cudaError_t e = prepare_bwd_g<MODE>();
    if (e != cudaSuccess) return e;
    const dim3 block(MX, MY);
    const dim3 grid((in.B + MX - 1) / MX);
    rt_bwd_g_kernel<MODE><<<grid, block, GLayout::bytes(in.L), s>>>(
        in, cl, ngb, wg, ct, rads, gr);
    return cudaGetLastError();
}

// out[0..7] = registers per thread, local memory bytes per thread, static
// and dynamic shared memory per block (at L layers), blocks per SM, 0 (no
// ring), threads and columns per block
template <int MODE>
cudaError_t info_bwd_g(int L, int* out) {
    cudaError_t e = prepare_bwd_g<MODE>();
    if (e != cudaSuccess) return e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, rt_bwd_g_kernel<MODE>);
    if (e != cudaSuccess) return e;
    const int smem = GLayout::bytes(L);
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, rt_bwd_g_kernel<MODE>, MT, smem);
    if (e != cudaSuccess) return e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = smem;
    out[4] = blocks;
    out[5] = 0;
    out[6] = MT;
    out[7] = MX;
    return cudaSuccess;
}

}  // namespace

// Inputs as rrtm_rt's (surf (3, 16, B)); c0..c5 the mode's cloud inputs
// (Clouds; unused ones null); ct (4, L+1, B) flux cotangents; rads (4, L,
// 140, B) the radiances K1 kept in the same step (rrtm_rt with rads, in
// the same mode) -> ct_taut, ct_fracs (L, 140, B), ct_play (L, 16, B),
// ct_plev (L+1, 16, B), ct_surf (3, 16, B) and g0..g5 the cloud inputs'
// cotangents, shaped like them.  mode: BANDED, FUSED or CLDF_OD (enum
// Mode).
RRTM_API int rrtm_rt_bwd_g(const float* taut, const float* fracs,
                           const float* play, const float* plev,
                           const float* surf, const int* ngb, const float* wg,
                           const float* c0, const float* c1, const float* c2,
                           const float* c3, const float* c4, const float* c5,
                           const float* ct, const float* rads, float* ct_taut,
                           float* ct_fracs, float* ct_play, float* ct_plev,
                           float* ct_surf, float* g0, float* g1, float* g2,
                           float* g3, float* g4, float* g5, int L, int B,
                           int mode, void* stream) {
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    const int ncld = mode == FUSED ? 6 : 2;
    const float* c[NCLD] = {c0, c1, c2, c3, c4, c5};
    float* g[NCLD] = {g0, g1, g2, g3, g4, g5};
    if (!rads || (mode != BANDED && mode != FUSED && mode != CLDF_OD))
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < ncld; ++i)
        if (!c[i] || !g[i]) return (int)cudaErrorInvalidValue;
    Inputs in{taut, fracs, play, plev, surf, nullptr, nullptr, nullptr,
              nullptr, L, B};
    Clouds cl{};
    GGrads gr{ct_taut, ct_fracs, ct_play, ct_plev, ct_surf, {}};
    for (int i = 0; i < NCLD; ++i) {
        cl.c[i] = c[i];
        gr.c[i] = g[i];
    }
    cudaStream_t s = (cudaStream_t)stream;
    switch (mode) {
    case BANDED:
        return (int)launch_bwd_g<BANDED>(in, cl, ngb, wg, ct, rads, gr, s);
    case FUSED:
        return (int)launch_bwd_g<FUSED>(in, cl, ngb, wg, ct, rads, gr, s);
    default:
        return (int)launch_bwd_g<CLDF_OD>(in, cl, ngb, wg, ct, rads, gr, s);
    }
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
