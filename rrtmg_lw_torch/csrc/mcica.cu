// K8: McICA sub-column sampling, the generator of the generate-then-
// radiate step.
//
// Replaces no Pallas kernel: the JAX package's generator is XLA
// (rrtmg_lw_tpu/ops/mcica.py:164 _native_cdf_blocked, a lax.scan up the
// layers that XLA fuses into one loop, then the compare at :225 and the
// pad).  In PyTorch the same scan is a Python loop of ~4 launches a layer
// over (L, 140, B) uniforms drawn first (550 MB at B=16384, L=60), so the
// generator runs as this one kernel: the draws in registers, the overlap
// walk up the layers with the carried CDF in a register, the mask written
// once.  The spec is ops/mcica.py: ``subcol_mask`` (the draw,
// ``philox_uniforms``, and the overlap core, ``overlap_cdf``, then the
// compare and the zero pad rows); the same operations in the same type,
// with -fmad=false, so the masks are bitwise the plain version's.
//
// The draw: Philox4x32-10 (Random123's philox4x32, written out here; curand
// is used only by the known-answer check, rrtm_philox).  One call at
// counter (column, g-point, layer block, stream) under the key's two words
// gives four words: the uniforms of 4 layers in float32 ((x >> 8) 2^-24)
// or of 2 in float64 (53 bits of two words, 2^-53); stream 0 the draw u,
// stream 1 icld 4/5's decorrelation draw u2.
//
// Bound on the H100: operations.  At B=16384, L=60, icld=2, float32 it
// reads 3.9 MB of cloud fraction and writes the 141.6 MB int8 mask
// (~0.04 ms at 3.35 TB/s), and makes 34.4 M Philox calls of ~110 integer
// operations (~0.23 ms at the 64 INT32 lanes of each of the 132 SMs); icld
// 4/5 draw twice as many.
//
// Design.  A block holds 32 columns (one a lane) and 8 g-rows (one a
// warp); the grid covers the columns and all g_pad rows, the pad rows'
// threads write zeros.  The block's (32, L) cloud fractions (CLDMIN
// applied) and, for icld 4/5, alphas are one contiguous piece of the
// (B, L) inputs: read with coalesced loads into shared memory, a stride of
// L | 1 a column so that the lanes' reads of one layer hit distinct banks.
// Each thread walks up its (g, column): a Philox call every 4 (float32) or
// 2 (float64) layers, the CDF carried in a register, one mask element
// stored a layer (a warp stores 32 consecutive columns).  The check entry
// reads given uniforms in place of the draw (chip_smoke.py's bitwise check
// of the overlap walk against the plain core).
#include <curand_philox4x32_x.h>

#include "rrtm.cuh"

namespace {

using rrtm::NGPT;

constexpr int MC_COLS = 32;                 // columns a block (lanes)
constexpr int MC_GROWS = 8;                 // g-rows a block (warps)
constexpr int MC_THREADS = MC_COLS * MC_GROWS;
constexpr unsigned PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr unsigned PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

// Philox4x32-10 of the counter x under the key (k0, k1), in place.
__device__ __forceinline__ void philox10(unsigned x[4], unsigned k0,
                                         unsigned k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r) {
            k0 += PHILOX_W0;
            k1 += PHILOX_W1;
        }
        const unsigned hi0 = __umulhi(PHILOX_M0, x[0]);
        const unsigned lo0 = PHILOX_M0 * x[0];
        const unsigned hi1 = __umulhi(PHILOX_M1, x[2]);
        const unsigned lo1 = PHILOX_M1 * x[2];
        const unsigned y0 = hi1 ^ x[1] ^ k0, y2 = hi0 ^ x[3] ^ k1;
        x[0] = y0;
        x[1] = lo1;
        x[2] = y2;
        x[3] = lo0;
    }
}

// The uniforms of one call's four words: exact in the type, in [0, 1).
template <typename T>
struct Uniforms;

template <>
struct Uniforms<float> {
    static constexpr int PER = 4;
    __device__ static void get(const unsigned x[4], float u[4]) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            u[j] = __uint2float_rn(x[j] >> 8) * 5.9604644775390625e-08f;
    }
};

template <>
struct Uniforms<double> {
    static constexpr int PER = 2;
    __device__ static void get(const unsigned x[4], double u[2]) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
            u[j] = __ull2double_rn(
                       ((unsigned long long)(x[2 * j] >> 5) << 26) |
                       (x[2 * j + 1] >> 6)) * 1.1102230246251565e-16;
    }
};

// the draw of layer block `blk` of (g, col) in `stream`
template <typename T>
__device__ __forceinline__ void draw(T* u, unsigned col, unsigned g,
                                     unsigned blk, unsigned stream,
                                     unsigned k0, unsigned k1) {
    unsigned x[4] = {col, g, blk, stream};
    philox10(x, k0, k1);
    Uniforms<T>::get(x, u);
}

__host__ __device__ __forceinline__ int col_stride(int L) { return L | 1; }

// OVL: the overlap, icld 1, 2, 3, or 4 (icld 4 and 5, which differ only
// in alpha).  M: the mask's type (int8, or T).  GIVEN: read the uniforms
// u (L, 140, B; OVL 3 its layer 0) and u2 (L, 140, B) in place of the
// draw.
template <typename T, typename M, int OVL, bool GIVEN>
__global__ void __launch_bounds__(MC_THREADS)
mcica_kernel(const T* __restrict__ cldfrac, const T* __restrict__ alpha,
             const T* __restrict__ u_in, const T* __restrict__ u2_in,
             M* __restrict__ mask, unsigned k0, unsigned k1, int L, int B,
             int gpad) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int LP = col_stride(L);
    T* cf = reinterpret_cast<T*>(smem);
    T* al = cf + MC_COLS * LP;              // OVL 4 only
    const int b0 = blockIdx.x * MC_COLS;
    const int nvalid = min(MC_COLS, B - b0);
    const T zero = 0, one = 1;
    for (int i = threadIdx.y * MC_COLS + threadIdx.x; i < nvalid * L;
         i += MC_THREADS) {
        const int c = i / L, s = c * LP + (i - c * L);
        const T v = cldfrac[(size_t)b0 * L + i];
        cf[s] = v < (T)1.0e-20 ? zero : v;  // CLDMIN
        if (OVL == 4) al[s] = alpha ? alpha[(size_t)b0 * L + i] : zero;
    }
    __syncthreads();

    const int lane = threadIdx.x;
    const int g = blockIdx.y * MC_GROWS + threadIdx.y;
    if (lane >= nvalid || g >= gpad) return;
    const unsigned col = b0 + lane;
    const size_t plane = (size_t)gpad * B;  // one layer of the mask
    M* out = mask + (size_t)g * B + col;
    if (g >= NGPT) {
        for (int l = 0; l < L; ++l) out[l * plane] = M(0);
        return;
    }
    const T* c = cf + lane * LP;
    const T* a = al + lane * LP;
    const size_t ustride = (size_t)NGPT * B;
    const T* ug = u_in + (size_t)g * B + col;
    const T* vg = u2_in + (size_t)g * B + col;
    constexpr int PER = Uniforms<T>::PER;
    T u[PER], v[PER];

    if (OVL == 3) {
        // one draw a (g, column), at every layer
        if (GIVEN)
            u[0] = ug[0];
        else
            draw(u, col, g, 0, 0, k0, k1);
        for (int l = 0; l < L; ++l)
            out[l * plane] = M(u[0] >= one - c[l] ? 1 : 0);
        return;
    }
    T prev = zero, thr_below = zero;
    for (int l0 = 0; l0 < L; l0 += PER) {
        if (GIVEN) {
#pragma unroll
            for (int j = 0; j < PER; ++j) {
                const size_t o = (size_t)min(l0 + j, L - 1) * ustride;
                u[j] = ug[o];
                if (OVL == 4) v[j] = vg[o];
            }
        } else {
            draw(u, col, g, l0 / PER, 0, k0, k1);
            if (OVL == 4) draw(v, col, g, l0 / PER, 1, k0, k1);
        }
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            const int l = l0 + j;
            if (l >= L) break;
            const T thr = one - c[l];
            T cdf = u[j];
            if (l > 0) {
                // icld 2: cloudy below keeps the number, clear below
                // rescales it into the clear part; icld 4/5: keep it
                // where u2 < alpha
                if (OVL == 2)
                    cdf = prev > thr_below ? prev : u[j] * thr_below;
                else if (OVL == 4)
                    cdf = v[j] < a[l] ? prev : u[j];
            }
            out[l * plane] = M(cdf >= thr ? 1 : 0);
            prev = cdf;
            thr_below = thr;
        }
    }
}

template <typename T, typename M, int OVL, bool GIVEN>
cudaError_t launch_k8(const void* cldfrac, const void* alpha, const void* u,
                      const void* u2, void* mask, unsigned k0, unsigned k1,
                      int L, int B, int gpad, cudaStream_t stream) {
    auto kernel = mcica_kernel<T, M, OVL, GIVEN>;
    const size_t smem =
        (size_t)MC_COLS * col_stride(L) * sizeof(T) * (OVL == 4 ? 2 : 1);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const dim3 grid((B + MC_COLS - 1) / MC_COLS,
                    (gpad + MC_GROWS - 1) / MC_GROWS);
    kernel<<<grid, dim3(MC_COLS, MC_GROWS), smem, stream>>>(
        (const T*)cldfrac, (const T*)alpha, (const T*)u, (const T*)u2,
        (M*)mask, k0, k1, L, B, gpad);
    return cudaGetLastError();
}

template <typename T, typename M, bool GIVEN>
cudaError_t launch_ovl(int ovl, const void* cldfrac, const void* alpha,
                       const void* u, const void* u2, void* mask,
                       unsigned k0, unsigned k1, int L, int B, int gpad,
                       cudaStream_t s) {
    switch (ovl) {
        case 1:
            return launch_k8<T, M, 1, GIVEN>(cldfrac, alpha, u, u2, mask, k0,
                                             k1, L, B, gpad, s);
        case 2:
            return launch_k8<T, M, 2, GIVEN>(cldfrac, alpha, u, u2, mask, k0,
                                             k1, L, B, gpad, s);
        case 3:
            return launch_k8<T, M, 3, GIVEN>(cldfrac, alpha, u, u2, mask, k0,
                                             k1, L, B, gpad, s);
        default:
            return launch_k8<T, M, 4, GIVEN>(cldfrac, alpha, u, u2, mask, k0,
                                             k1, L, B, gpad, s);
    }
}

template <typename T, bool GIVEN>
cudaError_t launch_mask(int ovl, bool mask_int8, const void* cldfrac,
                        const void* alpha, const void* u, const void* u2,
                        void* mask, unsigned k0, unsigned k1, int L, int B,
                        int gpad, cudaStream_t s) {
    if (mask_int8)
        return launch_ovl<T, signed char, GIVEN>(ovl, cldfrac, alpha, u, u2,
                                                 mask, k0, k1, L, B, gpad, s);
    return launch_ovl<T, T, GIVEN>(ovl, cldfrac, alpha, u, u2, mask, k0, k1,
                                   L, B, gpad, s);
}

__global__ void philox_check_kernel(const uint4* __restrict__ ctr,
                                    uint4* __restrict__ out, unsigned k0,
                                    unsigned k1, int n, int use_curand) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint4 c = ctr[i];
    if (use_curand) {
        out[i] = curand_Philox4x32_10(c, make_uint2(k0, k1));
        return;
    }
    unsigned x[4] = {c.x, c.y, c.z, c.w};
    philox10(x, k0, k1);
    out[i] = make_uint4(x[0], x[1], x[2], x[3]);
}

}  // namespace

// cldfrac (B, L) and alpha (B, L; null: 0) in float32 (dbl 0) or float64
// (dbl 1) -> the sub-column mask (L, gpad, B), int8 (mask_int8 1) or the
// input's type, rows 140.. zero; icld 1-5; the draws of key (k0, k1), or
// with u non-null the given uniforms u (L, 140, B; icld 3: its layer 0)
// and u2 (L, 140, B, icld 4/5).  The caller allocates the mask; every
// element is written.
RRTM_API int rrtm_mcica(const void* cldfrac, const void* alpha,
                        const void* u, const void* u2, void* mask,
                        unsigned k0, unsigned k1, int icld, int dbl,
                        int mask_int8, int L, int B, int gpad,
                        void* stream) {
    if (icld < 1 || icld > 5 || gpad < NGPT || L <= 0 || B <= 0)
        return (int)cudaErrorInvalidValue;
    const int ovl = icld == 5 ? 4 : icld;
    const cudaStream_t s = (cudaStream_t)stream;
    if (u != nullptr)
        return (int)(dbl ? launch_mask<double, true>(
                               ovl, mask_int8, cldfrac, alpha, u, u2, mask,
                               k0, k1, L, B, gpad, s)
                         : launch_mask<float, true>(
                               ovl, mask_int8, cldfrac, alpha, u, u2, mask,
                               k0, k1, L, B, gpad, s));
    return (int)(dbl ? launch_mask<double, false>(ovl, mask_int8, cldfrac,
                                                  alpha, u, u2, mask, k0, k1,
                                                  L, B, gpad, s)
                     : launch_mask<float, false>(ovl, mask_int8, cldfrac,
                                                 alpha, u, u2, mask, k0, k1,
                                                 L, B, gpad, s));
}

// The known-answer check of the hand-written Philox: ctr (n, 4) uint32 ->
// out (n, 4), by philox10 (use_curand 0) or curand_Philox4x32_10 (1).
RRTM_API int rrtm_philox(const void* ctr, void* out, unsigned k0,
                         unsigned k1, int n, int use_curand, void* stream) {
    if (n > 0)
        philox_check_kernel<<<(n + 255) / 256, 256, 0,
                              (cudaStream_t)stream>>>(
            (const uint4*)ctr, (uint4*)out, k0, k1, n, use_curand);
    return (int)cudaGetLastError();
}
