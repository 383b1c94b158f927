// K6: the adjoint of the RT sweep kernel (K1), clear sky and compact
// McICA clouds (idrv = 0): flux cotangents (4, L+1, B) -> cotangents of
// taut, fracs (L, 140, B), planklay (L, 16, B), planklev (L+1, 16, B),
// the surface rows (3, 16, B), and, cloudy, cw (L, 2, B), abi, abl
// (L, 16, B).
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
// recomputed as K1 forms them: cloudy_lay (one pass over the int8 mask
// at the start of the block, a warp ballot per layer kept as a bitmask
// in shared memory: 141 MB read in all, against a second copy of the
// flags from K1), the clear twin's iclddn (from the highest cloudy
// layer) and anyc, cldf >= 0.5, cwp >= CLDMIN, the od branches.  At od =
// secd * taut = 0 the maximum of the plain version passes half the
// gradient, as torch.maximum (and jnp.maximum) does at a tie.
//
// Bound on the H100: bytes.  Per (layer, g, column) the kernel reads
// taut and fracs twice (once per reverse sweep), the mask three times
// and each of the 2 or 4 radiances once, and writes ct_taut, ct_fracs
// twice (read-add in the second reverse sweep): ~8 GB at B=16384, L=60
// cloudy.  Each input read once and each output written once, the bytes
// are ~5.1 GB (1.5 ms at 3.35 TB/s), 2.2 GB of them the radiances;
// against that a few tens of flops and 2-3 expf per element and sweep.
// Design: 32 columns x 16 g-lanes, 9 g-points per thread.  The per-band
// sums (planklay, planklev, abi, abl) and the sum over all g (cw) are
// formed per layer from per-g values in shared memory, in a fixed order;
// the running per-g cotangents of the secant are summed at the end.  No
// atomics on floats: two runs are bitwise equal.
#include "rtrn.cuh"

namespace {

using namespace rrtm::rt;

struct Grads {
    float* taut;     // (L, 140, B)
    float* fracs;    // (L, 140, B)
    float* play;     // (L, 16, B)
    float* plev;     // (L+1, 16, B)
    float* surf;     // (3, 16, B): secdiff, semiss, plankbnd
    float* cw;       // (L, 2, B)
    float* abi;      // (L, 16, B)
    float* abl;      // (L, 16, B)
};

// Per-g cotangents of one step's inputs that are reduced over g.
enum GQ { Q_PLAY, Q_PLEV, Q_ABI, Q_ABL, Q_CW0, Q_CW1, NQ };

// The absorptivity, Planck transition and their derivatives in od.
__device__ __forceinline__ void factors_d(float od, bool small, float& a,
                                          float& tf, float& da, float& dtf) {
    if (small) {
        a = od - 0.5f * od * od;
        tf = REC_6 * od;
        da = 1.0f - od;
        dtf = REC_6;
    } else {
        const float e = expf(-od);
        a = 1.0f - e;
        tf = 1.0f - 2.0f * (1.0f / od - e / (1.0f - e));
        da = e;
        dtf = 2.0f / (od * od) - 2.0f * e / ((1.0f - e) * (1.0f - e));
    }
}

// Reverse of one advance() of layer l (Planck level `lev`) for one
// (column, g): lam, mu are the cotangents of the outgoing total-sky and
// clear radiances on entry and of the incoming ones (rad, radc) on
// exit.  Writes the per-g values to be reduced into gp and returns the
// cotangents of taut and fracs; adds the secant's to ct_secd.
template <bool CLOUDY>
__device__ __forceinline__ void step_bwd(const Inputs& in, int l, int lev,
                                         int g, int bd, float secd, float m,
                                         float cw0, float cw1, bool cly,
                                         bool twin, float rad, float radc,
                                         float& lam, float& mu, float& ct_tau,
                                         float& ct_fr, float& ct_secd,
                                         float* gp, int b) {
    const size_t B = in.B;
    const size_t gi = ((size_t)l * rrtm::NGPT + g) * B + b;
    const size_t bi = ((size_t)l * rrtm::NBAND + bd) * B + b;
    const float tau = in.taut[gi];
    const float fr = in.fracs[gi];
    const float bl = in.play[bi];
    const float dp = in.plev[((size_t)lev * rrtm::NBAND + bd) * B + b] - bl;
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
        ai = ciwp == 0.0f ? 0.0f : in.abi[bi];
        al = clwp == 0.0f ? 0.0f : in.abl[bi];
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

    // factors -> inputs
    ct_fr = ct_src * (bl + tfg * dp) + ct_srctot * (bl + tft * dp);
    const float ct_dp = fr * (ct_src * tfg + ct_srctot * tft);
    gp[Q_PLAY * rrtm::NGPT * NX] = fr * (ct_src + ct_srctot) - ct_dp;
    gp[Q_PLEV * rrtm::NGPT * NX] = ct_dp;
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
        gp[Q_ABI * rrtm::NGPT * NX] = ciwp == 0.0f ? 0.0f : ct_ai;
        gp[Q_ABL * rrtm::NGPT * NX] = clwp == 0.0f ? 0.0f : ct_al;
        gp[Q_CW0 * rrtm::NGPT * NX] = ct_ciwp * cf;
        gp[Q_CW1 * rrtm::NGPT * NX] = ct_clwp * cf;
    }
    const float ct_x = x > 0.0f ? ct_od : (x == 0.0f ? 0.5f * ct_od : 0.0f);
    ct_tau = ct_x * secd;
    ct_secd += ct_x * tau;
}

// Thread (tx, ty) gets the sums over the g-points of band ty of the nq
// per-g quantities in gp[q][g][tx], in g order.
template <int NQS>
__device__ __forceinline__ void band_sums(const float* gp, const int* goff,
                                          float* s) {
    const int tx = threadIdx.x, ty = threadIdx.y;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NQS; ++q) {
        float a = 0.0f;
        for (int g = goff[ty]; g < goff[ty + 1]; ++g)
            a += gp[(q * rrtm::NGPT + g) * NX + tx];
        s[q] = a;
    }
    __syncthreads();
}

// out[row] (= or += when `add`) v, for a valid column.
__device__ __forceinline__ void put(float* p, float v, bool add) {
    *p = add ? *p + v : v;
}

template <bool CLOUDY>
__global__ void __launch_bounds__(NX * NY)
rt_bwd_kernel(Inputs in, const int* __restrict__ ngb,
              const float* __restrict__ wg, const float* __restrict__ ct,
              const float* __restrict__ rads, Grads gr) {
    // gp[NQ or 2][140][NX] per-g values, then cly_bits[L]
    extern __shared__ float dyn[];
    constexpr int NQS = CLOUDY ? NQ : 2;
    float* gp_s = dyn;
    unsigned int* cly_bits = (unsigned int*)(dyn + NQS * rrtm::NGPT * NX);
    __shared__ float bpart[2][rrtm::NBAND][NX];
    __shared__ int ngb_s[rrtm::NGPT];
    __shared__ float wg_s[rrtm::NGPT];
    __shared__ int goff[rrtm::NBAND + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * NX + tx;
    const int L = in.L, B = in.B;
    for (int i = tid; i < rrtm::NGPT; i += NX * NY) {
        ngb_s[i] = ngb[i];
        wg_s[i] = wg[i];
    }
    for (int i = tid; i < L; i += NX * NY) cly_bits[i] = 0u;
    __syncthreads();
    for (int g = tid; g < rrtm::NGPT; g += NX * NY)
        if (g == 0 || ngb_s[g] != ngb_s[g - 1]) goff[ngb_s[g]] = g;
    if (tid == 0) goff[rrtm::NBAND] = rrtm::NGPT;
    __syncthreads();

    const int b0 = blockIdx.x * NX + tx;
    const bool valid = b0 < B;
    // ragged edge: compute on column B-1 (its stored radiances), never
    // write; its cloudy-layer bits exclude the lane, as K1's do
    const int b = valid ? b0 : B - 1;
    const size_t LGB = (size_t)L * rrtm::NGPT * B;
    const float* sD = rads;                // down radiance at level l
    const float* sU = rads + LGB;          // up radiance entering layer l
    const float* sDc = rads + 2 * LGB;     // their clear twins (cloudy)
    const float* sUc = rads + 3 * LGB;
    auto at_lg = [&](int l, int g) {
        return ((size_t)l * rrtm::NGPT + g) * B + b;
    };

    int bnd[GPT];
    float secd[GPT], rad[GPT], radc[GPT], m[GPT], ctsec[GPT];
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
        const int g = ty + k * NY;
        bnd[k] = g < rrtm::NGPT ? ngb_s[g] : 0;
        secd[k] = in.surf[(size_t)bnd[k] * B + b];
        rad[k] = radc[k] = m[k] = ctsec[k] = 0.0f;
    }
    auto load_layer = [&](int l, float& cw0, float& cw1) {
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int g = ty + k * NY;
            if (g < rrtm::NGPT)
                m[k] = (float)in.mask[((size_t)l * rrtm::NGPT_PAD + g) * B
                                      + b];
        }
        cw0 = in.cw[((size_t)l * 2) * B + b];
        cw1 = in.cw[((size_t)l * 2 + 1) * B + b];
    };

    // ---- 1. cloudy layers (a g-point with cloud fraction >= 0.5) and
    // the highest one, as K1's ballots form them ----
    int hi = -1;                           // highest cloudy layer
    if (CLOUDY) {
        for (int l = 0; l < L; ++l) {
            bool mine = false;
#pragma unroll
            for (int k = 0; k < GPT; ++k) {
                const int g = ty + k * NY;
                if (g < rrtm::NGPT)
                    mine |= (float)in.mask[((size_t)l * rrtm::NGPT_PAD + g)
                                           * B + b] >= 0.5f;
            }
            const unsigned bal = __ballot_sync(0xffffffffu, mine && valid);
            if (tx == 0 && bal) atomicOr(&cly_bits[l], bal);
        }
        __syncthreads();
        for (int l = L - 1; l >= 0 && hi < 0; --l)
            if ((cly_bits[l] >> tx) & 1u) hi = l;
    }
    const bool anyc = hi >= 0;

    // ---- 2. up sweep in reverse: layer L-1 .. 0 ----
    auto ct_at = [&](int row, int lev) {
        return ct[((size_t)row * (L + 1) + lev) * B + b];
    };
    // per-band sums of one reverse step of layer l, Planck level lev
    auto reduce_layer = [&](int l, int lev, bool add) {
        float s[NQ];
        band_sums<NQS>(gp_s, goff, s);
        const size_t bi = ((size_t)l * rrtm::NBAND + ty) * B + b0;
        if (valid) {
            put(gr.play + bi, s[Q_PLAY], add);
            put(gr.plev + ((size_t)lev * rrtm::NBAND + ty) * B + b0,
                s[Q_PLEV], add && lev > 0);
            if (CLOUDY) {
                put(gr.abi + bi, s[Q_ABI], add);
                put(gr.abl + bi, s[Q_ABL], add);
            }
        }
        if (CLOUDY) {                      // cw: sum of the band sums
            bpart[0][ty][tx] = s[Q_CW0];
            bpart[1][ty][tx] = s[Q_CW1];
            __syncthreads();
            if (ty < 2 && valid) {
                float a = 0.0f;
#pragma unroll
                for (int y = 0; y < rrtm::NBAND; ++y) a += bpart[ty][y][tx];
                put(gr.cw + ((size_t)l * 2 + ty) * B + b0, a, add);
            }
            __syncthreads();
        }
    };
#pragma unroll
    for (int k = 0; k < GPT; ++k) rad[k] = radc[k] = 0.0f;   // lam, mu
    for (int l = L - 1; l >= 0; --l) {
        const float cu = ct_at(UP, l + 1), ccu = ct_at(CLR_UP, l + 1);
        bool cly = false;
        float cw0 = 0.0f, cw1 = 0.0f;
        if (CLOUDY) {
            cly = (cly_bits[l] >> tx) & 1u;
            load_layer(l, cw0, cw1);
        }
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int g = ty + k * NY;
            if (g >= rrtm::NGPT) continue;
            rad[k] += wg_s[g] * cu;
            radc[k] += wg_s[g] * ccu;
            const float u = sU[at_lg(l, g)];
            const float uc = CLOUDY ? sUc[at_lg(l, g)] : u;
            float ct_tau, ct_fr;
            step_bwd<CLOUDY>(in, l, l + 1, g, bnd[k], secd[k], m[k], cw0,
                             cw1, cly, anyc, u, uc, rad[k], radc[k], ct_tau,
                             ct_fr, ctsec[k], gp_s + g * NX + tx, b);
            if (valid) {
                gr.taut[at_lg(l, g)] = ct_tau;
                gr.fracs[at_lg(l, g)] = ct_fr;
            }
        }
        reduce_layer(l, l + 1, false);
    }

    // ---- 3. surface reflection in reverse ----
    float ct_fr0[GPT];
    {
        const float cu = ct_at(UP, 0), ccu = ct_at(CLR_UP, 0);
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int g = ty + k * NY;
            ct_fr0[k] = 0.0f;
            if (g >= rrtm::NGPT) continue;
            const float lam = rad[k] + wg_s[g] * cu;
            const float mu = radc[k] + wg_s[g] * ccu;
            const float fr0 = in.fracs[(size_t)g * B + b];
            const float pbnd =
                in.surf[((size_t)2 * rrtm::NBAND + bnd[k]) * B + b];
            const float reflect =
                1.0f - in.surf[((size_t)rrtm::NBAND + bnd[k]) * B + b];
            const float d0 = sD[at_lg(0, g)];
            const float dc0 = CLOUDY ? sDc[at_lg(0, g)] : d0;
            const float ct_rad0 = lam + mu;
            ct_fr0[k] = ct_rad0 * pbnd;
            gp_s[(0 * rrtm::NGPT + g) * NX + tx] = -(lam * d0 + mu * dc0);
            gp_s[(1 * rrtm::NGPT + g) * NX + tx] = ct_rad0 * fr0;
            rad[k] = lam * reflect;
            radc[k] = mu * reflect;
        }
        float s[2];
        band_sums<2>(gp_s, goff, s);
        if (valid) {
            gr.surf[((size_t)rrtm::NBAND + ty) * B + b0] = s[0];
            gr.surf[((size_t)2 * rrtm::NBAND + ty) * B + b0] = s[1];
        }
    }

    // ---- 4. down sweep in reverse: layer 0 .. L-1 ----
    for (int l = 0; l < L; ++l) {
        const float cd = ct_at(DOWN, l), ccd = ct_at(CLR_DOWN, l);
        bool cly = false;
        float cw0 = 0.0f, cw1 = 0.0f;
        if (CLOUDY) {
            cly = (cly_bits[l] >> tx) & 1u;
            load_layer(l, cw0, cw1);
        }
        const bool icl = l <= hi;          // cloud at or above layer l
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int g = ty + k * NY;
            if (g >= rrtm::NGPT) continue;
            rad[k] += wg_s[g] * cd;
            radc[k] += wg_s[g] * ccd;
            const float d = l + 1 < L ? sD[at_lg(l + 1, g)] : 0.0f;
            const float dc = CLOUDY ? (l + 1 < L ? sDc[at_lg(l + 1, g)]
                                                 : 0.0f)
                                    : d;
            float ct_tau, ct_fr;
            step_bwd<CLOUDY>(in, l, l, g, bnd[k], secd[k], m[k], cw0, cw1,
                             cly, icl, d, dc, rad[k], radc[k], ct_tau, ct_fr,
                             ctsec[k], gp_s + g * NX + tx, b);
            if (valid) {
                gr.taut[at_lg(l, g)] += ct_tau;
                gr.fracs[at_lg(l, g)] += l == 0 ? ct_fr + ct_fr0[k] : ct_fr;
            }
        }
        reduce_layer(l, l, true);
    }

    // ---- 5. the secant, summed over both sweeps ----
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
        const int g = ty + k * NY;
        if (g < rrtm::NGPT) gp_s[g * NX + tx] = ctsec[k];
    }
    float s[1];
    band_sums<1>(gp_s, goff, s);
    if (valid) gr.surf[(size_t)ty * B + b0] = s[0];
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
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    if (!rads || (cloudy && (!mask || !cw || !abi || !abl || !ct_cw
                             || !ct_abi || !ct_abl)))
        return (int)cudaErrorInvalidValue;
    const Inputs in{taut, fracs, play, plev, surf, mask, cw, abi, abl, L, B};
    const Grads gr{ct_taut, ct_fracs, ct_play, ct_plev, ct_surf, ct_cw,
                   ct_abi, ct_abl};
    const dim3 block(NX, NY);
    const dim3 grid((B + NX - 1) / NX);
    cudaStream_t s = (cudaStream_t)stream;
    const int nq = cloudy ? NQ : 2;
    const size_t smem = (size_t)nq * rrtm::NGPT * NX * sizeof(float)
                        + (size_t)L * sizeof(unsigned int);
    cudaError_t e = cudaFuncSetAttribute(
        cloudy ? (const void*)rt_bwd_kernel<true>
               : (const void*)rt_bwd_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (cloudy)
        rt_bwd_kernel<true><<<grid, block, smem, s>>>(in, ngb, wg, ct, rads,
                                                       gr);
    else
        rt_bwd_kernel<false><<<grid, block, smem, s>>>(in, ngb, wg, ct,
                                                        rads, gr);
    return (int)cudaGetLastError();
}
