// K1: the longwave radiative-transfer sweep (idrv = 0), in four modes:
// clear sky, compact McICA clouds, per-band clouds under random overlap
// (banded, icld=1) and per-band clouds under maximum-random overlap
// (maxrand, icld 2/3).
//
// Replaces rrtmg_lw_tpu/ops/rtrn_pallas.py::_build_kernel.kernel (:140)
// in its clear, compact, banded (:156-157, :285-293, :311-312) and
// maxrand (:385-445, :538-598, via rt_maxrandom_pallas :1128) modes.
// The spec is rtrn.rt_sweep_blocked / rt_sweep_banded / rt_sweep_maxrand
// (use_lut=False) with the two-division Planck transition
// 1 - 2 (1/od - e/(1-e)), not the TPU kernel's one-division form.  The
// TPU's one-hot band -> g expansion and its bf16 three-way split are not
// carried over: a gather by the band of g is exact.
//
// Per column and g-point, the down sweep over levels, surface
// reflection, then the up sweep; radiances are summed over g with the
// weights WTDIFF * delwave(band) * FLUXFAC into up, down, clear up and
// clear down fluxes per level.
//
// Bound on the H100: bytes.  At B=16384, L=60 the inputs are ~1.1 GB
// of taut + fracs (L, 140, B), 0.13 GB of Planck sources, plus 0.14 GB
// of int8 mask (compact) or 0.06 GB of per-band cloud od and 4 MB of
// cloud fraction (banded; maxrand adds 0.06 GB of overlap rows), against
// ~30 flops and 1-2 expf per (level, g, column) and sweep: ~1.31 GB,
// ~0.39 ms at 3.35 TB/s (banded), ~1.37 GB, ~0.41 ms (maxrand).  The up
// sweep RECOMPUTES the per-level factors from taut instead of caching
// them: a cache of the 6 factors the up sweep needs would write and
// re-read 6 x 4 B per (level, g, column) (~3.3 GB at that shape), while
// recomputing re-reads only taut, fracs and the cloud inputs (~1.2 GB)
// and costs one more expf (two when cloudy) per level.
//
// Design: a block holds 32 columns (one warp across) x 16 g-lanes; each
// thread carries the radiances of 9 of the 140 g-points of its column
// in registers (maxrand: 5 floats per g, the total-sky stream, its clear
// twin, and the cloudy, clear and correction sub-streams).  Reads of
// (L, G, B) arrays coalesce across the warp; the per-column cloud rows
// are read by every g-lane and served from L1.  Per level, the
// g-weighted radiances are reduced across the 16 lanes through shared
// memory in a fixed order: no atomics on the fluxes, and the result is
// deterministic.
//
// Coupling across g-points: a layer is cloudy for a column when any of
// its g-points has mask >= 0.5 (compact) or where its cloud fraction is
// >= 1e-6 (banded, maxrand: the same for every g).  The clear twin
// stream of every g follows the cloudy stream until the first cloudy
// layer above (iclddn, down sweep) or anywhere in the column (up sweep).
// The compact mode forms cloudy_lay per layer with a warp ballot OR-ed
// into shared memory before any g of the layer is updated, keeps it for
// the up sweep, and carries iclddn as a running OR from the top; the
// banded mode reads the cloud fraction; the maxrand mode reads iclddn,
// the sub-stream restart flags and the overlap factors from the rows
// the overlap kernel (overlap.cu) made.
#include "rtrn.cuh"

namespace {

using namespace rrtm::rt;

// Sum the g-lanes' partial fluxes of each column in a fixed order and
// write flux rows f0 (lane 0) and f1 (lane 1) of out (4, L+1, B) at
// level `lev`.
__device__ __forceinline__ void reduce_write(float (*part)[NY][NX], float s0,
                                             float s1, float* out, int f0,
                                             int f1, int lev, int L, int B,
                                             int b, bool valid) {
    const int tx = threadIdx.x, ty = threadIdx.y;
    part[0][ty][tx] = s0;
    part[1][ty][tx] = s1;
    __syncthreads();
    if (ty < 2 && valid) {
        float s = 0.0f;
#pragma unroll
        for (int y = 0; y < NY; ++y) s += part[ty][y][tx];
        out[((size_t)(ty == 0 ? f0 : f1) * (L + 1) + lev) * B + b] = s;
    }
    __syncthreads();
}

template <int MODE>
__global__ void __launch_bounds__(NX * NY)
rt_kernel(Inputs in, const int* __restrict__ ngb,
          const float* __restrict__ wg, float* __restrict__ out) {
    constexpr bool MR = MODE == MAXRAND;
    constexpr int NSUB = MR ? GPT : 1;     // sub-stream carries (maxrand)
    extern __shared__ unsigned int cly_bits[];   // (L,) column bitmasks
    __shared__ float part[2][NY][NX];
    __shared__ int ngb_s[rrtm::NGPT];
    __shared__ float wg_s[rrtm::NGPT];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * NX + tx;
    const int L = in.L, B = in.B;
    for (int i = tid; i < rrtm::NGPT; i += NX * NY) {
        ngb_s[i] = ngb[i];
        wg_s[i] = wg[i];
    }
    if (MODE == COMPACT)
        for (int i = tid; i < L; i += NX * NY) cly_bits[i] = 0u;
    __syncthreads();

    const int b0 = blockIdx.x * NX + tx;
    const bool valid = b0 < B;
    const int b = valid ? b0 : B - 1;      // ragged edge: compute, never write

    int bnd[GPT];
    float secd[GPT], rad[GPT], radc[GPT], m[GPT];
    float cr[NSUB], kr[NSUB], rr[NSUB];
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
        const int g = ty + k * NY;
        bnd[k] = g < rrtm::NGPT ? ngb_s[g] : 0;
        secd[k] = in.surf[(size_t)bnd[k] * B + b];
        rad[k] = radc[k] = m[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < NSUB; ++k) cr[k] = kr[k] = rr[k] = 0.0f;
    // maxrand: one (L, 16, B) row of this column at layer l
    auto row = [&](int l, int r) {
        return in.cld[((size_t)l * NROW + r) * B + b];
    };

    // ---- down sweep: layer L-1 .. 0, radiance at each layer bottom ----
    bool icl = false;                      // cloud in path above (iclddn)
    for (int l = L - 1; l >= 0; --l) {
        bool cly = false, ist = false;
        float cw0 = 0.0f, cw1 = 0.0f, cf = 0.0f, fac[6];
        if (MODE == COMPACT) {
            bool mine = false;
#pragma unroll
            for (int k = 0; k < GPT; ++k) {
                const int g = ty + k * NY;
                if (g < rrtm::NGPT) {
                    m[k] = (float)in.mask[((size_t)l * rrtm::NGPT_PAD + g)
                                          * B + b];
                    mine |= m[k] >= 0.5f;
                }
            }
            const unsigned bal = __ballot_sync(0xffffffffu, mine && valid);
            if (tx == 0 && bal) atomicOr(&cly_bits[l], bal);
            cw0 = in.cw[((size_t)l * 2) * B + b];
            cw1 = in.cw[((size_t)l * 2 + 1) * B + b];
            __syncthreads();
            cly = (cly_bits[l] >> tx) & 1u;
            icl = icl || cly;
        } else if (MODE == BANDED) {
            cf = in.cld[(size_t)l * B + b];
            cly = cf >= CLOUD_GATE;
            icl = icl || cly;
        } else if (MR) {
            cf = row(l, R_CLDF);
            cly = cf >= CLOUD_GATE;
            icl = row(l, R_ICLDDN) > 0.0f;
            ist = row(l, R_IST_DN) > 0.0f;
#pragma unroll
            for (int i = 0; i < 6; ++i) fac[i] = row(l, R_DN + i);
        }
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int g = ty + k * NY;
            if (g >= rrtm::NGPT) continue;
            const Step f = layer_step<MODE>(in, l, l, g, bnd[k], secd[k],
                                            MODE == COMPACT ? m[k] : cf,
                                            cw0, cw1, b);
            if (MR)
                advance_mr(rad[k], radc[k], cr[k % NSUB], kr[k % NSUB],
                           rr[k % NSUB], f, cly, icl, ist, fac);
            else
                advance(rad[k], radc[k], f, cly, icl);
            s0 += wg_s[g] * rad[k];
            s1 += wg_s[g] * radc[k];
        }
        reduce_write(part, s0, s1, out, DOWN, CLR_DOWN, l, L, B, b0, valid);
    }
    if (ty < 2 && valid) {                 // nothing comes down at the top
        const int r = ty == 0 ? DOWN : CLR_DOWN;
        out[((size_t)r * (L + 1) + L) * B + b0] = 0.0f;
    }

    // ---- surface reflection ----
    {
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int g = ty + k * NY;
            if (g >= rrtm::NGPT) continue;
            const float rad0 = in.fracs[(size_t)g * B + b]
                * in.surf[((size_t)2 * rrtm::NBAND + bnd[k]) * B + b];
            const float reflect =
                1.0f - in.surf[((size_t)rrtm::NBAND + bnd[k]) * B + b];
            rad[k] = rad0 + reflect * rad[k];
            radc[k] = rad0 + reflect * radc[k];
            s0 += wg_s[g] * rad[k];
            s1 += wg_s[g] * radc[k];
        }
        reduce_write(part, s0, s1, out, UP, CLR_UP, 0, L, B, b0, valid);
    }
#pragma unroll
    for (int k = 0; k < NSUB; ++k) cr[k] = kr[k] = rr[k] = 0.0f;

    // ---- up sweep: layer 0 .. L-1, radiance at each layer top ----
    // any cloudy layer in the column: maxrand reads iclddn of layer 0
    const bool anyc = MR ? row(0, R_ICLDDN) > 0.0f : icl;
    for (int l = 0; l < L; ++l) {
        bool cly = false, ist = false;
        float cw0 = 0.0f, cw1 = 0.0f, cf = 0.0f, fac[6];
        if (MODE == COMPACT) {
            cly = (cly_bits[l] >> tx) & 1u;
#pragma unroll
            for (int k = 0; k < GPT; ++k) {
                const int g = ty + k * NY;
                if (g < rrtm::NGPT)
                    m[k] = (float)in.mask[((size_t)l * rrtm::NGPT_PAD + g)
                                          * B + b];
            }
            cw0 = in.cw[((size_t)l * 2) * B + b];
            cw1 = in.cw[((size_t)l * 2 + 1) * B + b];
        } else if (MODE == BANDED) {
            cf = in.cld[(size_t)l * B + b];
            cly = cf >= CLOUD_GATE;
        } else if (MR) {
            cf = row(l, R_CLDF);
            cly = cf >= CLOUD_GATE;
            ist = row(l, R_IST_UP) > 0.0f;
#pragma unroll
            for (int i = 0; i < 6; ++i) fac[i] = row(l, R_UP + i);
        }
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int g = ty + k * NY;
            if (g >= rrtm::NGPT) continue;
            const Step f = layer_step<MODE>(in, l, l + 1, g, bnd[k],
                                            secd[k],
                                            MODE == COMPACT ? m[k] : cf,
                                            cw0, cw1, b);
            if (MR)
                advance_mr(rad[k], radc[k], cr[k % NSUB], kr[k % NSUB],
                           rr[k % NSUB], f, cly, anyc, ist, fac);
            else
                advance(rad[k], radc[k], f, cly, anyc);
            s0 += wg_s[g] * rad[k];
            s1 += wg_s[g] * radc[k];
        }
        reduce_write(part, s0, s1, out, UP, CLR_UP, l + 1, L, B, b0, valid);
    }
}

template <int MODE>
cudaError_t launch(const Inputs& in, const int* ngb, const float* wg,
                   float* out, cudaStream_t s) {
    const dim3 block(NX, NY);
    const dim3 grid((in.B + NX - 1) / NX);
    const size_t smem =
        MODE == COMPACT ? (size_t)in.L * sizeof(unsigned int) : 0;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            rt_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return e;
    }
    rt_kernel<MODE><<<grid, block, smem, s>>>(in, ngb, wg, out);
    return cudaGetLastError();
}

}  // namespace

// taut, fracs (L, 140, B); play (L, 16, B); plev (L+1, 16, B); surf
// (3, 16, B) = secdiff, semiss, plankbnd; ngb (140,) 0-based band of each
// g; wg (140,) flux weights; mode (enum Mode):
//   COMPACT: mask (L, 144, B) int8, cw (L, 2, B), abi, abl (L, 16, B);
//   BANDED:  cld = cldfrac (L, B), taucb (L, 16, B) cloud od per band;
//   MAXRAND: cld = overlap rows (L, 16, B), taucb as BANDED;
// the other cloud pointers may be null.
// -> out (4, L+1, B) = up, down, clear up, clear down.
RRTM_API int rrtm_rt(const float* taut, const float* fracs, const float* play,
                     const float* plev, const float* surf, const int* ngb,
                     const float* wg, const int8_t* mask, const float* cw,
                     const float* abi, const float* abl, const float* cld,
                     const float* taucb, float* out, int L, int B, int mode,
                     void* stream) {
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    Inputs in{taut, fracs, play, plev, surf, mask, cw, abi, abl, L, B};
    in.cld = cld;
    in.taucb = taucb;
    cudaStream_t s = (cudaStream_t)stream;
    switch (mode) {
    case CLEAR:
        return (int)launch<CLEAR>(in, ngb, wg, out, s);
    case COMPACT:
        if (!mask || !cw || !abi || !abl) return (int)cudaErrorInvalidValue;
        return (int)launch<COMPACT>(in, ngb, wg, out, s);
    case BANDED:
        if (!cld || !taucb) return (int)cudaErrorInvalidValue;
        return (int)launch<BANDED>(in, ngb, wg, out, s);
    case MAXRAND:
        if (!cld || !taucb) return (int)cudaErrorInvalidValue;
        return (int)launch<MAXRAND>(in, ngb, wg, out, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
