// K1: the longwave radiative-transfer sweep, clear sky and compact McICA
// clouds (idrv = 0).
//
// Replaces rrtmg_lw_tpu/ops/rtrn_pallas.py::_build_kernel.kernel in its
// clear and compact-cloud modes.  The spec is rtrn.rt_random_overlap
// (use_lut=False) with the two-division Planck transition
// 1 - 2 (1/od - e/(1-e)), not the TPU kernel's one-division form.
//
// Per column and g-point, the down sweep over levels, surface
// reflection, then the up sweep; radiances are summed over g with the
// weights WTDIFF * delwave(band) * FLUXFAC into up, down, clear up and
// clear down fluxes per level.
//
// Bound on the H100: bytes.  At B=16384, L=60 the inputs are ~1.1 GB
// of taut + fracs (L, 140, B) plus a 0.14 GB int8 mask, against ~30
// flops and 1-2 expf per (level, g, column) and sweep.  The up sweep
// RECOMPUTES the per-level factors from taut instead of caching them:
// a cache of the 6 factors the up sweep needs would write and re-read
// 6 x 4 B per (level, g, column) (~3.3 GB at that shape), while
// recomputing re-reads only taut, fracs and the mask (~1.2 GB) and
// costs one more expf (two when cloudy) per level.
//
// Design: a block holds 32 columns (one warp across) x 16 g-lanes; each
// thread carries the radiances of 9 of the 140 g-points of its column
// in registers.  Reads of (L, G, B) arrays coalesce across the warp.
// Per level, the g-weighted radiances are reduced across the 16 lanes
// through shared memory in a fixed order: no atomics on the fluxes, and
// the result is deterministic.
//
// Coupling across g-points: a layer is cloudy for a column when any of
// its g-points has mask >= 0.5 (cloudy_lay); the clear twin stream of
// every g follows the cloudy stream until the first cloudy layer above
// (iclddn, down sweep) or anywhere in the column (up sweep).  The down
// sweep forms cloudy_lay per layer with a warp ballot OR-ed into shared
// memory before any g of the layer is updated, keeps it for the up
// sweep, and carries iclddn as a running OR from the top.
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

template <bool CLOUDY>
__global__ void __launch_bounds__(NX * NY)
rt_kernel(Inputs in, const int* __restrict__ ngb,
          const float* __restrict__ wg, float* __restrict__ out) {
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
    if (CLOUDY)
        for (int i = tid; i < L; i += NX * NY) cly_bits[i] = 0u;
    __syncthreads();

    const int b0 = blockIdx.x * NX + tx;
    const bool valid = b0 < B;
    const int b = valid ? b0 : B - 1;      // ragged edge: compute, never write

    int bnd[GPT];
    float secd[GPT], rad[GPT], radc[GPT], m[GPT];
#pragma unroll
    for (int k = 0; k < GPT; ++k) {
        const int g = ty + k * NY;
        bnd[k] = g < rrtm::NGPT ? ngb_s[g] : 0;
        secd[k] = in.surf[(size_t)bnd[k] * B + b];
        rad[k] = radc[k] = m[k] = 0.0f;
    }

    // ---- down sweep: layer L-1 .. 0, radiance at each layer bottom ----
    bool icl = false;                      // cloud in path above (iclddn)
    for (int l = L - 1; l >= 0; --l) {
        bool cly = false;
        float cw0 = 0.0f, cw1 = 0.0f;
        if (CLOUDY) {
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
        }
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int g = ty + k * NY;
            if (g >= rrtm::NGPT) continue;
            const Step f = layer_step<CLOUDY>(in, l, l, g, bnd[k], secd[k],
                                              m[k], cw0, cw1, b);
            advance(rad[k], radc[k], f, cly, icl);
            s0 += wg_s[g] * rad[k];
            s1 += wg_s[g] * radc[k];
        }
        reduce_write(part, s0, s1, out, DOWN, CLR_DOWN, l, L, B, b0, valid);
    }
    if (ty < 2 && valid) {                 // nothing comes down at the top
        const int row = ty == 0 ? DOWN : CLR_DOWN;
        out[((size_t)row * (L + 1) + L) * B + b0] = 0.0f;
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

    // ---- up sweep: layer 0 .. L-1, radiance at each layer top ----
    const bool anyc = icl;                 // any cloudy layer in the column
    for (int l = 0; l < L; ++l) {
        bool cly = false;
        float cw0 = 0.0f, cw1 = 0.0f;
        if (CLOUDY) {
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
        }
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int k = 0; k < GPT; ++k) {
            const int g = ty + k * NY;
            if (g >= rrtm::NGPT) continue;
            const Step f = layer_step<CLOUDY>(in, l, l + 1, g, bnd[k],
                                              secd[k], m[k], cw0, cw1, b);
            advance(rad[k], radc[k], f, cly, anyc);
            s0 += wg_s[g] * rad[k];
            s1 += wg_s[g] * radc[k];
        }
        reduce_write(part, s0, s1, out, UP, CLR_UP, l + 1, L, B, b0, valid);
    }
}

}  // namespace

// taut, fracs (L, 140, B); play (L, 16, B); plev (L+1, 16, B); surf
// (3, 16, B) = secdiff, semiss, plankbnd; ngb (140,) 0-based band of each
// g; wg (140,) flux weights; compact clouds (cloudy != 0): mask
// (L, 144, B) int8, cw (L, 2, B), abi, abl (L, 16, B).
// -> out (4, L+1, B) = up, down, clear up, clear down.
RRTM_API int rrtm_rt(const float* taut, const float* fracs, const float* play,
                     const float* plev, const float* surf, const int* ngb,
                     const float* wg, const int8_t* mask, const float* cw,
                     const float* abi, const float* abl, float* out, int L,
                     int B, int cloudy, void* stream) {
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    if (cloudy && (!mask || !cw || !abi || !abl))
        return (int)cudaErrorInvalidValue;
    const Inputs in{taut, fracs, play, plev, surf, mask, cw, abi, abl, L, B};
    const dim3 block(NX, NY);
    const dim3 grid((B + NX - 1) / NX);
    cudaStream_t s = (cudaStream_t)stream;
    if (cloudy) {
        const size_t smem = (size_t)L * sizeof(unsigned int);
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                rt_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        rt_kernel<true><<<grid, block, smem, s>>>(in, ngb, wg, out);
    } else {
        rt_kernel<false><<<grid, block, 0, s>>>(in, ngb, wg, out);
    }
    return (int)cudaGetLastError();
}
