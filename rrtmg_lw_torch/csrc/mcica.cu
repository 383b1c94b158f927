// K8: McICA sub-column sampling, the generator of the generate-then-
// radiate step.
//
// Replaces no Pallas kernel: the JAX package's generator is XLA
// (rrtmg_lw_tpu/ops/mcica.py:164 _native_cdf_blocked, a lax.scan up the
// layers that XLA fuses into one loop, then the compare at :225 and the
// pad).  In PyTorch the same scan is a Python loop of ~4 launches a layer
// over (L, 140, B) uniforms drawn first (550 MB at B=16384, L=60), so the
// generator runs as this one kernel: the draws in registers, the overlap
// walk up the layers with the carried CDF in registers, the mask written
// once.  The spec is ops/mcica.py: ``subcol_mask`` (the draw,
// ``philox_uniforms``, and the overlap core, ``overlap_cdf``, then the
// compare and the zero pad rows); the masks are bitwise the plain
// version's (-fmad=false).
//
// The draw: Philox4x32-10 (Random123's philox4x32, written out here; curand
// is used only by the known-answer check, rrtm_philox).  One call at
// counter (column, g-point, layer block, stream) under the key's two words
// gives four words: the uniforms of 4 layers in float32 (m 2^-24, m = x >>
// 8) or of 2 in float64 (m 2^-53, m the 53 bits of two words); stream 0
// the draw u, stream 1 icld 4/5's decorrelation draw u2.  The ten round
// keys are the same for every thread: the host adds the Weyl increments
// and passes them as kernel arguments, so a round is two 32 x 32 -> 64
// multiplies and two three-input xors with a constant operand.
//
// Bound on the H100: operations.  At B=16384, L=60, icld=2, float32 it
// reads 3.9 MB of cloud fraction and writes the 141.6 MB int8 mask
// (0.043 ms at 3.35 TB/s), and makes 34.4 M Philox calls (chip_smoke.py
// counts 92 operations a call and 5 a cell: 0.0575 ms at 67 TOP/s); icld
// 4/5 draw twice as many.  What binds in practice is Philox's twenty 32 x
// 32 -> 64 multiplies a call (IMAD.WIDE, which the SM's one 16-lane
// integer-multiply pipe takes four cycles a warp; ~17 a call here, the
// first rounds' products shared by a lane's four columns), beside the
// walk's integer and compare work on the other pipe.
//
// Design.  A lane owns 4 consecutive columns and a warp 128, so a warp
// stores one whole 128-byte line of the int8 mask a layer (a 32-bit store
// a lane; float masks a float4 or two double2 a lane) where B % 4 == 0 and
// the mask is 16-byte aligned; elsewhere the element-store instantiation
// (VEC false) runs, the ragged column tail masked in both.  A block is 128
// columns x 8 warps and covers 48 g-rows, 6 a warp walked one after
// another; pad rows 140.. are written with the same stores.  The (layer,
// column) work is done once a block, not once a g-row: a staging pass
// writes, for the block's columns and layers (layer-major, so a lane's 4
// columns are one vector load), the exact value each compare of the walk
// needs, after CLDMIN.  Where the compared value is a raw uniform m 2^-k
// (icld 1 and 3; icld 4/5 throughout, whose carried CDF is always an
// earlier uniform) that is an integer: u >= thr <=> m >= ceil(thr 2^k), u2
// < alpha <=> m2 < ceil(alpha 2^k) (clamped to [0, 2^k]; NaN: never;
// ops/mcica.py ``uniform_thresholds``), so the walk compares Philox words
// with integers (one shift-and-add a compare) and converts nothing.  icld
// 2 keeps its float arithmetic (cdf = prev > thr_below ? prev : u
// thr_below, then cdf >= thr, u = float(m) 2^-24 as the plain version
// has it), with the threshold staged as a float.  Layer 0 takes no
// special path: the carries start at prev 0 and thr_below 1 (u 1 = u), and
// alpha's staged threshold at layer 0 keeps nothing.  Where the staged
// layers would not fit 74 KB (three blocks an SM; icld 4/5 run two, whose
// two streams' words need more than 80 registers), they are staged in
// chunks of layers, the walk's carries kept in registers.  The check entry
// (GIVEN) reads given uniforms and keeps the float walk (chip_smoke.py's
// bitwise check of the walk against the plain core).
#include <curand_philox4x32_x.h>

#include <type_traits>

#include "rrtm.cuh"

namespace {

using rrtm::NGPT;

constexpr int MC_CPL = 4;                     // columns a lane
constexpr int MC_COLS = 32 * MC_CPL;          // columns a block (a warp)
constexpr int MC_WARPS = 8;                   // warps a block
constexpr int MC_THREADS = 32 * MC_WARPS;
constexpr int MC_ROUNDS = 6;                  // g-rows a warp
constexpr int MC_GROWS = MC_WARPS * MC_ROUNDS;  // g-rows a block
constexpr int MC_MIN_BLOCKS = 3;              // blocks an SM
// icld 4/5 draw two streams: at 80 registers their walk spills
constexpr int MC_MIN_BLOCKS_2S = 2;
constexpr size_t MC_STAGE_MAX = 74 * 1024;    // staged bytes a block
constexpr unsigned PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr unsigned PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

// the ten round keys of a key (k0, k1): k + r W
struct Keys {
    unsigned k0[10], k1[10];
};

Keys round_keys(unsigned k0, unsigned k1) {
    Keys k;
    for (int r = 0; r < 10; ++r) {
        k.k0[r] = k0 + (unsigned)r * PHILOX_W0;
        k.k1[r] = k1 + (unsigned)r * PHILOX_W1;
    }
    return k;
}

// Philox4x32-10 of the counter x, in place.
__device__ __forceinline__ void philox10(unsigned x[4], const Keys& k) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        const unsigned long long p0 = (unsigned long long)PHILOX_M0 * x[0];
        const unsigned long long p1 = (unsigned long long)PHILOX_M1 * x[2];
        const unsigned y0 = (unsigned)(p1 >> 32) ^ x[1] ^ k.k0[r];
        const unsigned y2 = (unsigned)(p0 >> 32) ^ x[3] ^ k.k1[r];
        x[0] = y0;
        x[1] = (unsigned)p1;
        x[2] = y2;
        x[3] = (unsigned)p0;
    }
}

// A uniform u = m 2^-K in the type T from one call's four words: W, the
// word the walk carries (float32: the Philox word, m = w >> 8; float64: m,
// 53 bits of two words), its compare with an integer threshold, and its
// value.
template <typename T>
struct Draw;

template <>
struct Draw<float> {
    using W = unsigned;
    using U = int;                      // thresholds, |.| <= 2^24
    static constexpr int PER = 4;       // layers a call
    static constexpr float SCALE = 16777216.0f,
                           ULP = 5.9604644775390625e-08f;
    __device__ static void words(const unsigned x[4], unsigned w[4]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = x[j];
    }
    // m + t, m = w >> 8 (|t| <= 2^24: no overflow): its sign word
    __device__ static int diff(unsigned w, int t) { return (int)(w >> 8) + t; }
    __device__ static float value(unsigned w) {
        return __uint2float_rn(w >> 8) * ULP;
    }
    __device__ static float ceil_(float v) { return ceilf(v); }
};

template <>
struct Draw<double> {
    using W = long long;
    using U = long long;
    static constexpr int PER = 2;
    static constexpr double SCALE = 9007199254740992.0,
                            ULP = 1.1102230246251565e-16;
    __device__ static void words(const unsigned x[4], long long w[2]) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
            w[j] = ((long long)(x[2 * j] >> 5) << 26) | (x[2 * j + 1] >> 6);
    }
    __device__ static int diff(long long w, long long t) {
        return (int)((w + t) >> 32);
    }
    __device__ static double value(long long w) {
        return __ull2double_rn(w) * ULP;
    }
    __device__ static double ceil_(double v) { return ceil(v); }
};

// -T, T = ceil(v 2^K) clamped to [0, 2^K]: for u = m 2^-K, u >= v <=> m -
// T >= 0 and u < v <=> m - T < 0.  NaN compares false either way: T is
// `never` (2^K for >=, 0 for <).
template <typename T>
__device__ __forceinline__ typename Draw<T>::U neg_threshold(T v, T never) {
    const T one = Draw<T>::SCALE;
    T c = v == v ? Draw<T>::ceil_(v * one) : never;
    c = c < (T)0 ? (T)0 : c;
    c = c > one ? one : c;
    return -(typename Draw<T>::U)c;
}

// prmt's generic mode: a selector nibble with its top bit set replicates
// the sign bit of the byte it selects
__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b,
                                         unsigned s) {
#ifdef __CUDA_ARCH__
    unsigned d;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
    return d;
#else
    const unsigned long long v = (unsigned long long)b << 32 | a;
    unsigned d = 0;
    for (int i = 0; i < 4; ++i) {
        const unsigned n = s >> (4 * i) & 15;
        unsigned byte = (unsigned)(v >> (8 * (n & 7))) & 255;
        if (n & 8) byte = byte & 128 ? 255 : 0;
        d |= byte << (8 * i);
    }
    return d;
#endif
}

// four int8 mask elements: 1 where the sign word is not negative
__device__ __forceinline__ unsigned mask_bytes(const int sw[4]) {
    const unsigned lo = prmt(sw[0], sw[1], 0xFB);
    const unsigned hi = prmt(sw[2], sw[3], 0xFB);
    return ~prmt(lo, hi, 0x5410) & 0x01010101u;
}

// four staged values of a lane, one or two vector loads
__device__ __forceinline__ void load4(float v[4], const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(int v[4], const int* p) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void load4(double v[4], const double* p) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void load4(long long v[4], const long long* p) {
    const longlong2 a = reinterpret_cast<const longlong2*>(p)[0];
    const longlong2 b = reinterpret_cast<const longlong2*>(p)[1];
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// A lane's four mask elements of one (layer, g) row at p, cloudy (1) where
// the sign word is not negative: one store (VEC) or n element stores.
template <typename M, bool VEC>
__device__ __forceinline__ void put(M* p, const int sw[4], int n) {
    if constexpr (std::is_same_v<M, signed char>) {
        if constexpr (VEC) {
            *reinterpret_cast<unsigned*>(p) = mask_bytes(sw);
        } else {
            for (int j = 0; j < n; ++j) p[j] = sw[j] < 0 ? 0 : 1;
        }
    } else {
        M v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = sw[j] < 0 ? M(0) : M(1);
        if constexpr (!VEC) {
            for (int j = 0; j < n; ++j) p[j] = v[j];
        } else if constexpr (std::is_same_v<M, float>) {
            *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
        } else {
            reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
            reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
        }
    }
}

// OVL: the overlap, icld 1, 2, 3, or 4 (icld 4 and 5, which differ only
// in alpha).  M: the mask's type (int8, or T).  GIVEN: read the uniforms
// u (L, 140, B; OVL 3 its layer 0) and u2 (L, 140, B) in place of the
// draw.  VEC: vector stores (B % 4 == 0).  lc: layers staged at once (L,
// or a multiple of the layers a Philox call gives).
template <typename T, typename M, int OVL, bool GIVEN, bool VEC>
__global__ void __launch_bounds__(MC_THREADS,
                                  OVL == 4 ? MC_MIN_BLOCKS_2S : MC_MIN_BLOCKS)
mcica_kernel(const T* __restrict__ cldfrac, const T* __restrict__ alpha,
             const T* __restrict__ u_in, const T* __restrict__ u2_in,
             M* __restrict__ mask, const Keys keys, int L, int B, int gpad,
             int lc) {
    using D = Draw<T>;
    using W = typename D::W;
    using U = typename D::U;
    // staged a (layer, column): the float threshold 1 - c (icld 2, given
    // uniforms) or -ceil((1 - c) 2^K); icld 4/5 also alpha or -ceil(alpha
    // 2^K), at layer 0 -inf or 0, so that layer 0 keeps no CDF
    constexpr bool FLOAT_WALK = GIVEN || OVL == 2;
    using S = std::conditional_t<FLOAT_WALK, T, U>;
    constexpr int PER = D::PER;
    extern __shared__ __align__(16) unsigned char smem[];
    S* s0 = reinterpret_cast<S*>(smem);
    S* s1 = s0 + (size_t)lc * MC_COLS;  // OVL 4 only
    const T zero = 0, one = 1;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int b0 = blockIdx.x * MC_COLS;
    const int col0 = b0 + MC_CPL * lane;
    const int ncols = min(MC_CPL, B - col0);  // this lane's, <= 0: none
    const size_t plane = (size_t)gpad * B;    // one layer of the mask
    const size_t ustride = (size_t)NGPT * B;  // one layer of u, u2
    const int nch = (L + lc - 1) / lc;

    for (int rnd = 0; rnd < MC_ROUNDS; ++rnd) {
        const int grow0 = blockIdx.y * MC_GROWS + rnd * MC_WARPS;
        if (grow0 >= gpad) break;                // the whole block
        const int g = grow0 + warp;
        const bool walk = ncols > 0 && g < gpad;
        // the walk's carries: the CDF below, as a float (FLOAT_WALK) or as
        // its word (icld 4/5), and icld 2's threshold below; layer 0 takes
        // its own uniform (u * 1, and 0 > 1 is false)
        T prev[4], tb[4];
        W prevw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) prev[j] = zero, tb[j] = one, prevw[j] = 0;
        W w3[4];                                 // icld 3: the g-row's draw
        if constexpr (OVL == 3 && !GIVEN) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                unsigned x[4] = {(unsigned)(col0 + j), (unsigned)g, 0u, 0u};
                philox10(x, keys);
                W w[PER];
                D::words(x, w);
                w3[j] = w[0];
            }
        }
        for (int ch = 0; ch < nch; ++ch) {
            const int l0 = ch * lc, l1 = min(L, l0 + lc);
            if (nch > 1 || rnd == 0) {
                if (rnd > 0 || ch > 0) __syncthreads();  // readers done
                for (int r = warp; r < l1 - l0; r += MC_WARPS) {
                    const int l = l0 + r;
                    for (int c = lane; c < MC_COLS; c += 32) {
                        const int col = b0 + c;
                        T cf = zero, a = zero;
                        if (col < B) {
                            cf = cldfrac[(size_t)col * L + l];
                            if (OVL == 4 && alpha)
                                a = alpha[(size_t)col * L + l];
                        }
                        cf = cf < (T)1.0e-20 ? zero : cf;   // CLDMIN
                        const T thr = one - cf;
                        if constexpr (FLOAT_WALK)
                            s0[r * MC_COLS + c] = thr;
                        else
                            s0[r * MC_COLS + c] = neg_threshold(thr, D::SCALE);
                        if constexpr (OVL == 4) {
                            if constexpr (GIVEN)
                                s1[r * MC_COLS + c] = l ? a : -(one / zero);
                            else
                                s1[r * MC_COLS + c] =
                                    l ? neg_threshold(a, zero) : U(0);
                        }
                    }
                }
                __syncthreads();
            }
            if (!walk) continue;
            M* out = mask + (size_t)g * B + col0 + (size_t)l0 * plane;
            if (g >= NGPT) {                     // pad rows: zeros
                const int sw[4] = {-1, -1, -1, -1};
                for (int l = l0; l < l1; ++l, out += plane)
                    put<M, VEC>(out, sw, ncols);
                continue;
            }
            if constexpr (GIVEN) {
                // the float walk on given uniforms, a layer at a time
                for (int l = l0; l < l1; ++l, out += plane) {
                    S th[4], al[4];
                    load4(th, s0 + (l - l0) * MC_COLS + MC_CPL * lane);
                    if (OVL == 4)
                        load4(al, s1 + (l - l0) * MC_COLS + MC_CPL * lane);
                    const size_t o = (size_t)(OVL == 3 ? 0 : l) * ustride +
                                     (size_t)g * B + col0;
                    int sw[4];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const T u = j < ncols ? u_in[o + j] : zero;
                        T cdf = u;
                        if (OVL == 2) {
                            cdf = prev[j] > tb[j] ? prev[j] : u * tb[j];
                            tb[j] = th[j];
                        } else if (OVL == 4) {
                            cdf = (j < ncols ? u2_in[o + j] : zero) < al[j]
                                      ? prev[j] : u;
                        }
                        sw[j] = cdf >= th[j] ? 0 : -1;
                        prev[j] = cdf;
                    }
                    put<M, VEC>(out, sw, ncols);
                }
                continue;
            }
            if constexpr (OVL == 3) {
                for (int l = l0; l < l1; ++l, out += plane) {
                    S th[4];
                    load4(th, s0 + (l - l0) * MC_COLS + MC_CPL * lane);
                    int sw[4];
#pragma unroll
                    for (int j = 0; j < 4; ++j) sw[j] = D::diff(w3[j], th[j]);
                    put<M, VEC>(out, sw, ncols);
                }
                continue;
            }
            // drawing: a Philox call a column every PER layers
            auto layer = [&](const W (&wu)[4][PER], const W (&wv)[4][PER],
                             int jj, int l) {
                S th[4];
                load4(th, s0 + (l - l0) * MC_COLS + MC_CPL * lane);
                int sw[4];
                if constexpr (OVL == 1) {
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        sw[j] = D::diff(wu[j][jj], th[j]);
                } else if constexpr (OVL == 4) {
                    // keep the CDF below where u2 < alpha: m2 - ceil(alpha
                    // 2^K) < 0
                    S na[4];
                    load4(na, s1 + (l - l0) * MC_COLS + MC_CPL * lane);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const W cur = D::diff(wv[j][jj], na[j]) < 0
                                          ? prevw[j] : wu[j][jj];
                        sw[j] = D::diff(cur, th[j]);
                        prevw[j] = cur;
                    }
                } else {
                    // icld 2: cloudy below keeps the number, clear below
                    // rescales it into the clear part
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const T p = D::value(wu[j][jj]) * tb[j];
                        const T cdf = prev[j] > tb[j] ? prev[j] : p;
                        sw[j] = cdf >= th[j] ? 0 : -1;
                        prev[j] = cdf;
                        tb[j] = th[j];
                    }
                }
                put<M, VEC>(out, sw, ncols);
                out += plane;
            };
            for (int lb = l0; lb < l1; lb += PER) {
                W wu[4][PER], wv[4][PER];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    unsigned x[4] = {(unsigned)(col0 + j), (unsigned)g,
                                     (unsigned)(lb / PER), 0u};
                    philox10(x, keys);
                    D::words(x, wu[j]);
                    if constexpr (OVL == 4) {
                        unsigned y[4] = {(unsigned)(col0 + j), (unsigned)g,
                                         (unsigned)(lb / PER), 1u};
                        philox10(y, keys);
                        D::words(y, wv[j]);
                    }
                }
                if (lb + PER <= l1) {
#pragma unroll
                    for (int jj = 0; jj < PER; ++jj)
                        layer(wu, wv, jj, lb + jj);
                } else {
#pragma unroll
                    for (int jj = 0; jj < PER; ++jj)
                        if (lb + jj < l1) layer(wu, wv, jj, lb + jj);
                }
            }
        }
    }
}

int g_mcica_path = 0;  // the store path of the last launch

template <typename T, typename M, int OVL, bool GIVEN, bool VEC>
cudaError_t launch_k8(const void* cldfrac, const void* alpha, const void* u,
                      const void* u2, void* mask, const Keys& keys, int L,
                      int B, int gpad, cudaStream_t stream) {
    auto kernel = mcica_kernel<T, M, OVL, GIVEN, VEC>;
    // the staged rows' bytes; where all L do not fit MC_STAGE_MAX, chunks
    // of a multiple of the layers a call gives
    const size_t row = (size_t)MC_COLS * sizeof(T) * (OVL == 4 ? 2 : 1);
    int lc = L;
    for (int nch = 2; (size_t)lc * row > MC_STAGE_MAX; ++nch) {
        constexpr int PER = Draw<T>::PER;
        lc = ((L + nch - 1) / nch + PER - 1) / PER * PER;
    }
    const size_t smem = (size_t)lc * row;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const dim3 grid((B + MC_COLS - 1) / MC_COLS,
                    (gpad + MC_GROWS - 1) / MC_GROWS);
    kernel<<<grid, MC_THREADS, smem, stream>>>(
        (const T*)cldfrac, (const T*)alpha, (const T*)u, (const T*)u2,
        (M*)mask, keys, L, B, gpad, lc);
    return cudaGetLastError();
}

template <typename T, typename M, bool GIVEN, bool VEC>
cudaError_t launch_ovl(int ovl, const void* cldfrac, const void* alpha,
                       const void* u, const void* u2, void* mask,
                       const Keys& k, int L, int B, int gpad,
                       cudaStream_t s) {
    switch (ovl) {
        case 1:
            return launch_k8<T, M, 1, GIVEN, VEC>(cldfrac, alpha, u, u2, mask,
                                                  k, L, B, gpad, s);
        case 2:
            return launch_k8<T, M, 2, GIVEN, VEC>(cldfrac, alpha, u, u2, mask,
                                                  k, L, B, gpad, s);
        case 3:
            return launch_k8<T, M, 3, GIVEN, VEC>(cldfrac, alpha, u, u2, mask,
                                                  k, L, B, gpad, s);
        default:
            return launch_k8<T, M, 4, GIVEN, VEC>(cldfrac, alpha, u, u2, mask,
                                                  k, L, B, gpad, s);
    }
}

template <typename T, typename M, bool GIVEN>
cudaError_t launch_path(bool vec, int ovl, const void* cldfrac,
                        const void* alpha, const void* u, const void* u2,
                        void* mask, const Keys& k, int L, int B, int gpad,
                        cudaStream_t s) {
    if (vec)
        return launch_ovl<T, M, GIVEN, true>(ovl, cldfrac, alpha, u, u2, mask,
                                             k, L, B, gpad, s);
    return launch_ovl<T, M, GIVEN, false>(ovl, cldfrac, alpha, u, u2, mask,
                                          k, L, B, gpad, s);
}

template <typename T, bool GIVEN>
cudaError_t launch_mask(bool vec, int ovl, bool mask_int8,
                        const void* cldfrac, const void* alpha, const void* u,
                        const void* u2, void* mask, const Keys& k, int L,
                        int B, int gpad, cudaStream_t s) {
    if (mask_int8)
        return launch_path<T, signed char, GIVEN>(vec, ovl, cldfrac, alpha, u,
                                                  u2, mask, k, L, B, gpad, s);
    return launch_path<T, T, GIVEN>(vec, ovl, cldfrac, alpha, u, u2, mask, k,
                                    L, B, gpad, s);
}

__global__ void philox_check_kernel(const uint4* __restrict__ ctr,
                                    uint4* __restrict__ out, const Keys keys,
                                    unsigned k0, unsigned k1, int n,
                                    int use_curand) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint4 c = ctr[i];
    if (use_curand) {
        out[i] = curand_Philox4x32_10(c, make_uint2(k0, k1));
        return;
    }
    unsigned x[4] = {c.x, c.y, c.z, c.w};
    philox10(x, keys);
    out[i] = make_uint4(x[0], x[1], x[2], x[3]);
}

}  // namespace

// cldfrac (B, L) and alpha (B, L; null: 0) in float32 (dbl 0) or float64
// (dbl 1) -> the sub-column mask (L, gpad, B), int8 (mask_int8 1) or the
// input's type, rows 140.. zero; icld 1-5; the draws of key (k0, k1), or
// with u non-null the given uniforms u (L, 140, B; icld 3: its layer 0)
// and u2 (L, 140, B, icld 4/5).  The caller allocates the mask; every
// element is written, by vector stores where B % 4 == 0 and the mask is
// 16-byte aligned (rrtm_mcica_path: 1), else element by element (2).
RRTM_API int rrtm_mcica(const void* cldfrac, const void* alpha,
                        const void* u, const void* u2, void* mask,
                        unsigned k0, unsigned k1, int icld, int dbl,
                        int mask_int8, int L, int B, int gpad,
                        void* stream) {
    if (icld < 1 || icld > 5 || gpad < NGPT || L <= 0 || B <= 0)
        return (int)cudaErrorInvalidValue;
    const int ovl = icld == 5 ? 4 : icld;
    const bool vec = B % 4 == 0 && (size_t)mask % 16 == 0;
    g_mcica_path = vec ? 1 : 2;
    const Keys k = round_keys(k0, k1);
    const cudaStream_t s = (cudaStream_t)stream;
    if (u != nullptr)
        return (int)(dbl ? launch_mask<double, true>(
                               vec, ovl, mask_int8, cldfrac, alpha, u, u2,
                               mask, k, L, B, gpad, s)
                         : launch_mask<float, true>(
                               vec, ovl, mask_int8, cldfrac, alpha, u, u2,
                               mask, k, L, B, gpad, s));
    return (int)(dbl ? launch_mask<double, false>(vec, ovl, mask_int8,
                                                  cldfrac, alpha, u, u2, mask,
                                                  k, L, B, gpad, s)
                     : launch_mask<float, false>(vec, ovl, mask_int8,
                                                 cldfrac, alpha, u, u2, mask,
                                                 k, L, B, gpad, s));
}

// The store path of the last rrtm_mcica launch: 1 vector, 2 scalar.
RRTM_API int rrtm_mcica_path() { return g_mcica_path; }

// The known-answer check of the hand-written Philox: ctr (n, 4) uint32 ->
// out (n, 4), by philox10 (use_curand 0) or curand_Philox4x32_10 (1).
RRTM_API int rrtm_philox(const void* ctr, void* out, unsigned k0,
                         unsigned k1, int n, int use_curand, void* stream) {
    if (n > 0)
        philox_check_kernel<<<(n + 255) / 256, 256, 0,
                              (cudaStream_t)stream>>>(
            (const uint4*)ctr, (uint4*)out, round_keys(k0, k1), k0, k1, n,
            use_curand);
    return (int)cudaGetLastError();
}
