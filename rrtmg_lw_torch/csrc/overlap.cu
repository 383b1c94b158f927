// The overlap rows of K1's maxrand mode and their adjoint.
//
// Forward: per column, the maximum-random overlap factors between
// adjacent layers in each sweep direction (rrtmg_lw_rtrnmr.f90:347-428
// up, :430-506 down) and the flags the sub-stream recursion reads.
// Replaces the XLA pre-pass of rrtmg_lw_tpu/ops/rtrn_pallas.py::
// rt_maxrandom_pallas (rows16, :1155-1166), which the TPU computes with
// two lax.scan over layers (rtrnmr._overlap_factors_up/_down,
// rrtmg_lw_tpu/ops/rtrnmr.py:33-162).  The spec is rtrnmr.overlap_rows:
// the same elementwise operations in the same order, with -fmad=false
// and IEEE division, so the rows equal the plain version's.
//
// Adjoint (the gradient step): the cotangent of the rows (L, 16, B) to
// that of the cloud fraction (B, L); the spec is the plain vjp of
// rtrnmr.overlap_rows (torch.autograd), JAX's vjp of rows16.
//
// Bound on the H100: bytes.  At B=16384, L=60 the forward reads 4 MB of
// cloud fraction and writes 63 MB of rows (~0.02 ms at 3.35 TB/s); the
// adjoint reads the 13 rows that carry a gradient (51 MB) and the cloud
// fraction, and writes the cloud fraction's cotangent.
//
// Design.  A block holds 32 columns, all layers.  Its (32, L) cloud
// fractions are one contiguous piece of the (B, L) input: read with
// coalesced loads into shared memory (a stride of L | 1 floats a
// column, so that the column walks below hit 32 banks).
// - Forward (128 threads): the only sequential part is the (rat1, rat2)
//   carry of each column and pass, 0/1 flags that the factors of the next
//   layer read.  Warp 0 walks the up pass, warp 1 the down pass, one lane
//   a column, on shared memory, and writes each layer's six factors as it
//   goes (the down pass also R_ICLDDN, its running OR): each store a
//   128-byte row segment.  Warps 2-3 write the cloud fraction and the two
//   restart-flag rows meanwhile.  overlap_step computes only the branch a
//   layer takes (a layer that is not live, most of them, writes zeros),
//   with the operations of the plain version on the values it selects.
//   512 blocks at B=16384: all resident at once, the passes' latency
//   the time.
// - Adjoint: the carries enter the factors only as constants on branches
//   that carry no gradient (clr1's and cld1's), so it needs no chain: a
//   warp takes a layer, its lanes the columns, and forms the partials of
//   both passes' factors at that layer with respect to c[l-1], c[l] and
//   c[l+1] (overlap_step_bwd, torch's tie rules: maximum and minimum
//   pass half the cotangent to each of two equal operands, a `where`
//   nothing to the branch not taken, a safe division nothing to a
//   denominator replaced by 1); after a barrier each (column, layer)
//   sums its three in a fixed order, with the cotangent of the
//   R_CLDF row, and the block writes them with coalesced stores.  No
//   atomics: two runs are bitwise equal.
#include "rtrn.cuh"

namespace {

using namespace rrtm::rt;

constexpr int OC = 32;            // columns per block
constexpr int OT = 256;           // threads per block of the adjoint
constexpr int OW = OT / 32;       // its warps
constexpr int OTF = 128;          // threads per block of the forward

__device__ __forceinline__ float safe_div(float a, float b) {
    return a / (b == 0.0f ? 1.0f : b);
}

// One layer of either pass (rtrnmr._overlap_step): nxt is the cloud
// fraction of the layer the sweep goes to, prv of the one it comes from.
// Writes the six factors (clr1, clr2, cld1, cld2, cmb1, cmb2), zero
// where not `live`, and updates (rat1, rat2) where `live`.  The plain
// version forms every candidate and selects; this forms the selected
// one alone, by the same operations: the same values.
__device__ __forceinline__ void overlap_step(float c, float nxt, float prv,
                                             bool ist, bool live,
                                             float& rat1, float& rat2,
                                             float* f) {
    float clr1 = 0.0f, clr2 = 0.0f, cld1 = 0.0f, cld2 = 0.0f;
    float cmb1 = 0.0f, cmb2 = 0.0f;
    const bool inc = nxt >= c;
    if (live) {
        if (ist) {
            if (inc)
                clr2 = c < 1.0f ? safe_div(nxt - c, 1.0f - c) : 0.0f;
            else
                cld2 = safe_div(c - nxt, c);
        } else {
            if (inc) {
                const float fmax = fmaxf(c, prv);
                clr1 = nxt < fmax ? safe_div(nxt - c, prv - c) : rat2;
                clr2 = nxt > fmax ? safe_div(nxt - fmax, 1.0f - fmax)
                                  : 0.0f;
            } else {
                const float fmin = fminf(c, prv);
                const bool le = nxt <= fmin;
                cld1 = le ? rat1 : safe_div(c - nxt, c - fmin);
                cld2 = le ? safe_div(fmin - nxt, fmin) : 0.0f;
            }
            cmb1 = fmaxf(fminf(nxt - c, prv - c), 0.0f);
            cmb2 = fmaxf(fminf(c - nxt, c - prv), 0.0f);
        }
        rat1 = inc && (clr1 > 0.0f || clr2 > 0.0f) ? 1.0f : 0.0f;
        rat2 = !inc && (cld1 > 0.0f || cld2 > 0.0f) ? 1.0f : 0.0f;
    }
    f[0] = clr1;
    f[1] = clr2;
    f[2] = cld1;
    f[3] = cld2;
    f[4] = cmb1;
    f[5] = cmb2;
}

// The cotangent g of a / safe(b) into a (ga) and b (gb; 0 where b == 0,
// which the safe division replaced by 1), as torch's division: grad / b,
// -grad * ((a / b) / b).
__device__ __forceinline__ void div_bwd(float g, float a, float b,
                                        float& ga, float& gb) {
    const float bs = b == 0.0f ? 1.0f : b;
    ga = g / bs;
    gb = b == 0.0f ? 0.0f : -g * ((a / bs) / bs);
}

// The cotangent g of max(x, y) (min: `mx` false) into x and y: all to the
// larger (smaller), half to each where they are equal.
__device__ __forceinline__ void ext_bwd(float g, float x, float y, bool mx,
                                        float& gx, float& gy) {
    if (x == y) {
        gx = gy = 0.5f * g;
    } else {
        const bool xwins = mx ? x > y : x < y;
        gx = xwins ? g : 0.0f;
        gy = xwins ? 0.0f : g;
    }
}

// The vjp of overlap_step at a live layer: g the cotangents of the six
// factors -> those of c, nxt and prv (added to dc, dn, dp).
__device__ __forceinline__ void overlap_step_bwd(float c, float nxt,
                                                 float prv, bool ist,
                                                 const float* g, float& dc,
                                                 float& dn, float& dp) {
    const bool inc = nxt >= c;
    // the where(inc, ...) pairs: clr rows where inc, cld rows elsewhere
    const float gclr1 = inc ? g[0] : 0.0f, gclr2 = inc ? g[1] : 0.0f;
    const float gcld1 = inc ? 0.0f : g[2], gcld2 = inc ? 0.0f : g[3];
    float ga, gb;
    if (ist) {
        // clr2_ist = c < 1 ? (nxt - c) / (1 - c) : 0
        if (c < 1.0f) {
            div_bwd(gclr2, nxt - c, 1.0f - c, ga, gb);
            dn += ga;
            dc += -ga - gb;
        }
        // cld2_ist = (c - nxt) / safe(c)
        div_bwd(gcld2, c - nxt, c, ga, gb);
        dc += ga + gb;
        dn -= ga;
        return;
    }
    float gfmax = 0.0f, gfmin = 0.0f;
    const float fmax = fmaxf(c, prv);
    const float fmin = fminf(c, prv);
    // clr1_e = nxt < fmax ? (nxt - c) / safe(prv - c) : rat2
    if (nxt < fmax) {
        div_bwd(gclr1, nxt - c, prv - c, ga, gb);
        dn += ga;
        dc += -ga - gb;
        dp += gb;
    }
    // clr2_e = nxt > fmax ? (nxt - fmax) / safe(1 - fmax) : 0
    if (nxt > fmax) {
        div_bwd(gclr2, nxt - fmax, 1.0f - fmax, ga, gb);
        dn += ga;
        gfmax += -ga - gb;
    }
    // cld1_e = le ? rat1 : (c - nxt) / safe(c - fmin);
    // cld2_e = le ? (fmin - nxt) / safe(fmin) : 0
    if (nxt <= fmin) {
        div_bwd(gcld2, fmin - nxt, fmin, ga, gb);
        gfmin += ga + gb;
        dn -= ga;
    } else {
        div_bwd(gcld1, c - nxt, c - fmin, ga, gb);
        dc += ga + gb;
        dn -= ga;
        gfmin -= gb;
    }
    float gx, gy;
    ext_bwd(gfmax, c, prv, true, gx, gy);
    dc += gx;
    dp += gy;
    ext_bwd(gfmin, c, prv, false, gx, gy);
    dc += gx;
    dp += gy;
    // cmb1 = max(min(nxt - c, prv - c), 0)
    float gm, gz;
    float u = nxt - c, v = prv - c;
    ext_bwd(g[4], fminf(u, v), 0.0f, true, gm, gz);
    ext_bwd(gm, u, v, false, gx, gy);
    dn += gx;
    dp += gy;
    dc += -gx - gy;
    // cmb2 = max(min(c - nxt, c - prv), 0)
    u = c - nxt;
    v = c - prv;
    ext_bwd(g[5], fminf(u, v), 0.0f, true, gm, gz);
    ext_bwd(gm, u, v, false, gx, gy);
    dc += gx + gy;
    dn -= gx;
    dp -= gy;
}

// the stride of a column's cloud fractions in shared memory: odd, so
// that 32 threads walking 32 columns at one layer hit 32 banks
__host__ __device__ __forceinline__ int col_stride(int L) { return L | 1; }

// the block's (nvalid, L) cloud fractions -> cf (OC, col_stride(L))
__device__ __forceinline__ void load_cf(const float* __restrict__ cldf,
                                        float* cf, int b0, int nvalid,
                                        int L) {
    const int LP = col_stride(L);
    const float* src = cldf + (size_t)b0 * L;
    for (int i = threadIdx.x; i < nvalid * L; i += blockDim.x) {
        const int col = i / L;
        cf[col * LP + (i - col * L)] = src[i];
    }
}

__global__ void __launch_bounds__(OTF)
overlap_kernel(const float* __restrict__ cldf, float* __restrict__ rows,
               int L, int B) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int LP = col_stride(L);
    float* cf = reinterpret_cast<float*>(smem);
    const int b0 = blockIdx.x * OC;
    const int nvalid = min(OC, B - b0);
    load_cf(cldf, cf, b0, nvalid, L);
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane >= nvalid) return;
    const float* c = cf + lane * LP;
    const size_t Bz = B;
    float* out = rows + b0 + lane;
    auto cloudy = [&](int l) { return c[l] >= CLOUD_GATE; };
    if (warp >= 2) {
        // the cloud fraction and the restart flags of each sub-stream
        for (int l = warp - 2; l < L; l += OTF / 32 - 2) {
            float* o = out + (size_t)l * NROW * Bz;
            o[R_CLDF * Bz] = c[l];
            o[R_IST_UP * Bz] = (l == 0 || !cloudy(l - 1)) ? 1.0f : 0.0f;
            o[R_IST_DN * Bz] = (l == L - 1 || !cloudy(l + 1)) ? 1.0f : 0.0f;
        }
        return;
    }
    // the pass of this warp: up, layer 0 .. L-1 (the top layer is never
    // live); down, layer L-1 .. 0 (the bottom layer is never live), with
    // the cloud at or above each layer
    const bool up = warp == 0;
    float rat1 = 0.0f, rat2 = 0.0f, f[6];
    bool above = false;
    for (int i = 0; i < L; ++i) {
        const int l = up ? i : L - 1 - i;
        const float below = l > 0 ? c[l - 1] : 0.0f;
        const float upper = l < L - 1 ? c[l + 1] : 0.0f;
        float* o = out + (size_t)l * NROW * Bz;
        if (up) {
            overlap_step(c[l], upper, below, l == 0 || !cloudy(l - 1),
                         cloudy(l) && l < L - 1, rat1, rat2, f);
        } else {
            overlap_step(c[l], below, upper, l == L - 1 || !cloudy(l + 1),
                         cloudy(l) && l > 0, rat1, rat2, f);
            above = above || cloudy(l);
            o[R_ICLDDN * Bz] = above ? 1.0f : 0.0f;
        }
        const int r0 = up ? R_UP : R_DN;
#pragma unroll
        for (int q = 0; q < 6; ++q) o[(r0 + q) * Bz] = f[q];
    }
}

__global__ void __launch_bounds__(OT)
overlap_bwd_kernel(const float* __restrict__ cldf,
                   const float* __restrict__ ct_rows,
                   float* __restrict__ ct_cldf, int L, int B) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int LP = col_stride(L);
    float* cf = reinterpret_cast<float*>(smem);
    // per (column, layer m): the R_CLDF row's cotangent plus both passes'
    // partials in c[m] (t), their partials in c[m - 1] (qm) and in
    // c[m + 1] (qp)
    float* t = cf + OC * LP;
    float* qm = t + OC * LP;
    float* qp = qm + OC * LP;
    const int b0 = blockIdx.x * OC;
    const int nvalid = min(OC, B - b0);
    load_cf(cldf, cf, b0, nvalid, L);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    if (lane < nvalid) {
        const float* c = cf + lane * LP;
        const size_t Bz = B;
        auto cloudy = [&](int l) { return c[l] >= CLOUD_GATE; };
        for (int l = threadIdx.x >> 5; l < L; l += OW) {
            const float* g = ct_rows + (size_t)l * NROW * Bz + b0 + lane;
            const float below = l > 0 ? c[l - 1] : 0.0f;
            const float upper = l < L - 1 ? c[l + 1] : 0.0f;
            float gu[6], gd[6];
#pragma unroll
            for (int i = 0; i < 6; ++i) {
                gu[i] = g[(R_UP + i) * Bz];
                gd[i] = g[(R_DN + i) * Bz];
            }
            // up: nxt = c[l + 1], prv = c[l - 1]; down: the reverse
            float uc = 0.0f, un = 0.0f, up = 0.0f;
            float dc = 0.0f, dn = 0.0f, dp = 0.0f;
            if (cloudy(l) && l < L - 1)
                overlap_step_bwd(c[l], upper, below,
                                 l == 0 || !cloudy(l - 1), gu, uc, un, up);
            if (cloudy(l) && l > 0)
                overlap_step_bwd(c[l], below, upper,
                                 l == L - 1 || !cloudy(l + 1), gd, dc, dn,
                                 dp);
            const int s = lane * LP + l;
            t[s] = g[R_CLDF * Bz] + (uc + dc);
            qm[s] = up + dn;
            qp[s] = un + dp;
        }
    }
    __syncthreads();
    float* dst = ct_cldf + (size_t)b0 * L;
    for (int i = threadIdx.x; i < nvalid * L; i += OT) {
        const int col = i / L, l = i - col * L, s = col * LP + l;
        float v = t[s];
        if (l > 0) v += qp[s - 1];
        if (l < L - 1) v += qm[s + 1];
        dst[i] = v;
    }
}

// dynamic shared memory of a block: the cloud fractions, and in the
// adjoint three more floats a (column, layer)
size_t overlap_smem(int L, bool bwd) {
    const size_t f = (size_t)OC * col_stride(L) * 4;
    return bwd ? 4 * f : f;
}

template <typename Kernel>
cudaError_t overlap_prepare(Kernel* kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// cldf (B, L) cloud fraction -> rows (L, 16, B) (enum Row).
RRTM_API int rrtm_overlap(const float* cldf, float* rows, int L, int B,
                          void* stream) {
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    const size_t smem = overlap_smem(L, false);
    const cudaError_t e = overlap_prepare(overlap_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    overlap_kernel<<<(B + OC - 1) / OC, OTF, smem, (cudaStream_t)stream>>>(
        cldf, rows, L, B);
    return (int)cudaGetLastError();
}

// The adjoint: cldf (B, L), ct_rows (L, 16, B) the cotangent of the rows
// (the flag rows 1-3 are not read) -> ct_cldf (B, L).
RRTM_API int rrtm_overlap_bwd(const float* cldf, const float* ct_rows,
                              float* ct_cldf, int L, int B, void* stream) {
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    const size_t smem = overlap_smem(L, true);
    const cudaError_t e = overlap_prepare(overlap_bwd_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    overlap_bwd_kernel<<<(B + OC - 1) / OC, OT, smem,
                         (cudaStream_t)stream>>>(cldf, ct_rows, ct_cldf, L,
                                                 B);
    return (int)cudaGetLastError();
}
