// Shared by K1 (rtrn_kernel.cuh) and its adjoint K6 (rtrn_bwd.cu): the
// inputs, the factor functions and one step of the sweep recurrences of
// ops/rtrn.py (use_lut=False, the two-division Planck transition), the
// block tile both use (16 columns x 16 g-lanes, two blocks per SM), the
// staging of a level's rows into a ring in shared memory (cp.async, one
// mbarrier per slot) and Hopper's bulk tensor copies (TMA) with their
// tensor maps.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include <type_traits>

#include "rrtm.cuh"
#include "spec.cuh"

namespace rrtm {
namespace rt {

constexpr int KX = 16;                       // columns per block
constexpr int KY = 16;                       // g-lanes per column
constexpr int KT = KX * KY;                  // threads per block
constexpr int KW = KT / 32;                  // warps per block
constexpr int KG = rrtm::NGPT;               // g-points
constexpr int KGPT = (KG + KY - 1) / KY;     // g-points per thread
constexpr int KNB = rrtm::NBAND;
constexpr int BLOCKS_PER_SM = 2;
// shared memory of an SM on the H100 (228 KB) and the 1 KB the system
// reserves per block
constexpr int SMEM_SM = 233472;
constexpr int SMEM_RESERVED = 1024;

constexpr int align16(int x) { return (x + 15) & ~15; }

constexpr float CLDMIN = 1.0e-20f;
constexpr float REC_6 = 0.166667f;
// a layer holds a per-band cloud where cldfrac >= CLOUD_GATE (banded and
// maxrand modes; rtrn.CLOUD_GATE)
constexpr float CLOUD_GATE = 1.0e-6f;

// K1's modes (rtrn_cuda.MODES): clear sky; compact McICA (mask x layer
// water paths); per-band clouds under random overlap (icld=1); per-band
// clouds under maximum-random overlap (icld 2/3); McICA per-g arrays with
// cldprmc inline (fused, inflag=2); McICA per-g cloud fraction and cloud
// od (cldf-odcld, after cldprmc)
enum Mode { CLEAR = 0, COMPACT = 1, BANDED = 2, MAXRAND = 3, FUSED = 4,
            CLDF_OD = 5 };

// modes whose cloud fraction is per g-point (a layer is cloudy where any
// g of it is, formed by a warp ballot)
__host__ __device__ constexpr bool per_g_clouds(int mode) {
    return mode == COMPACT || mode == FUSED || mode == CLDF_OD;
}

// modes whose gradient-step launch of K1 at idrv=1 also keeps the d/dT
// derivatives entering each layer (planes P_DDT, P_DDT + 1 of its
// radiances), so that their d/dT K6 (rtrn_bwd_g.cu, rtrn_bwd_mr.cu) takes
// no lam scratch: all but clear, whose d/dT K6 (rtrn_bwd.cu) keeps its
// scratch (P's stores and reads cost what the scratch's do, PERF.md)
__host__ __device__ constexpr bool keeps_ddt(int mode) {
    return mode == COMPACT || mode == BANDED || mode == MAXRAND
           || mode == FUSED || mode == CLDF_OD;
}
// the plane of the d/dT derivative entering layer l, then its clear twin's,
// in K1 SAVE's radiances of those modes at idrv=1 ((6, L, 140, B): D, U,
// their clear twins, P, PC)
constexpr int P_DDT = 4;

// rows of the (L, 16, B) overlap rows of the maxrand mode
// (rtrnmr.overlap_rows): cldfrac, restart flags of the up and down
// sub-streams, cloud at or above, 6 down factors, 6 up factors
enum Row { R_CLDF = 0, R_IST_UP = 1, R_IST_DN = 2, R_ICLDDN = 3,
           R_DN = 4, R_UP = 10, NROW = 16 };

// rows of the (4, L+1, B) flux output; idrv=1 adds the derivatives of
// the upward fluxes with respect to the surface temperature, (6, L+1, B)
enum Flux { UP = 0, DOWN = 1, CLR_UP = 2, CLR_DOWN = 3, D_UP = 4,
            D_CLR_UP = 5 };

// rtrn._gas_factors: absorptivity and Planck transition, small-od branch
// for od <= 0.06.
__device__ __forceinline__ void gas_factors(float od, float& a, float& tf) {
    if (od <= 0.06f) {
        a = od - 0.5f * od * od;
        tf = REC_6 * od;
    } else {
        const float e = expf(-od);
        a = 1.0f - e;
        tf = 1.0f - 2.0f * (1.0f / od - e / (1.0f - e));
    }
}

// rtrn._tot_factors: the same for gas + cloud, small branch od < 0.06.
__device__ __forceinline__ void tot_factors(float od, float& a, float& tf) {
    if (od < 0.06f) {
        a = od - 0.5f * od * od;
        tf = REC_6 * od;
    } else {
        const float e = expf(-od);
        a = 1.0f - e;
        tf = 1.0f - 2.0f * (1.0f / od - e / (1.0f - e));
    }
}

// The same factors and their derivatives in od, for the adjoints K6
// (rtrn_bwd.cu, rtrn_bwd_mr.cu): `small` selects the branch.
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

struct Inputs {
    const float* taut;     // (L, 140, B)
    const float* fracs;    // (L, 140, B)
    const float* play;     // (L, 16, B)
    const float* plev;     // (L+1, 16, B)
    // (3, 16, B): secdiff, semiss, plankbnd; idrv: (4, 16, B), + the
    // temperature derivative of plankbnd
    const float* surf;
    const int8_t* mask;    // (L, 144, B) or null
    const float* cw;       // (L, 2, B): ciwp, clwp
    const float* abi;      // (L, 16, B)
    const float* abl;      // (L, 16, B)
    int L, B;
    // banded: cldfrac (L, B); maxrand: overlap rows (L, 16, B)
    const float* cld = nullptr;
    const float* taucb = nullptr;  // (L, 16, B) cloud od per band
    // per-g McICA arrays (L, 144, B): cloud fraction (fused, cldf-odcld),
    // water paths (fused) and cloud od (fused: the input taucmc;
    // cldf-odcld: cldprmc's output)
    const float* cldf = nullptr;
    const float* ciwp = nullptr;
    const float* clwp = nullptr;
    const float* tauc = nullptr;
};

// K1's inputs in reduced storage (SPEC != SPEC_F32): taut and fracs
// point at taug and fracs in that storage, and the aerosol od (L, 16, B)
// is added to the decoded taug; in float32 (Inputs) taut already holds
// it.  A struct of its own, so that the float32 kernels' parameters stay
// as they were.
struct SpecInputs : Inputs {
    const float* taua = nullptr;
};

template <int SPEC>
using KernelInputs =
    std::conditional_t<SPEC == SPEC_F32, Inputs, SpecInputs>;

// Per (layer, g) factors of one sweep step (rtrn_kernel.cuh staged_step;
// the Planck source is that of the level bounding the step, l for the
// down sweep, l+1 for up).
struct Step {
    float at, atot, ef, cf, src, srctot;
};

// One level of the total-sky stream and its clear twin (rtrn.py
// down_step / up_step).  In a cloudy layer (cly) the cloudy recurrence
// runs for every g of the column; the clear twin follows the clear
// recurrence where `twin` holds and copies the total-sky stream
// elsewhere.  Clear sky is cly = twin = false.
__device__ __forceinline__ void advance(float& rad, float& radc,
                                        const Step& f, bool cly, bool twin) {
    const float gs = f.at * f.src;
    const float rcld = rad - rad * (f.at + f.ef * (1.0f - f.at)) + gs
                       + f.cf * (f.srctot * f.atot - gs);
    const float rclr = rad + (f.src - rad) * f.at;
    const float rn = cly ? rcld : rclr;
    radc = twin ? radc + (f.src - radc) * f.at : rn;
    rad = rn;
}

// One layer of the up sweep's derivatives with respect to the surface
// temperature (idrv=1; rtrn._ddt_step, rtrnmc.f90:495-527): dl through
// the gas transmittance, in a cloudy layer (cly) through the blend of the
// cloudy and clear transmittances with the cloud fraction (every mode,
// maxrand too); the clear twin dc through the gas alone where `twin`
// holds, else dl.
__device__ __forceinline__ void advance_ddt(float& dl, float& dc,
                                            const Step& f, bool cly,
                                            bool twin) {
    const float dn = cly ? dl * f.cf * (1.0f - f.atot)
                               + dl * (1.0f - f.cf) * (1.0f - f.at)
                         : dl * (1.0f - f.at);
    dc = twin ? dc * (1.0f - f.at) : dn;
    dl = dn;
}

// The adjoint of advance_ddt at one (column, g) of a layer, for K6 at
// idrv=1 (rtrn_bwd.cu, rtrn_bwd_g.cu, rtrn_bwd_mr.cu; rtrn.ddt_adjoint):
// ct_t and ct_tc are the cotangents of the layer's d/dT transmittance t
// (cly ? cf (1 - atot) + (1 - cf) (1 - at) : 1 - at) and of its clear
// twin's tc = 1 - at, each the cotangent of the outgoing derivative
// times the incoming one; t and tc come back.
struct DdtStep {
    float ct_t, ct_tc, t, tc;
};

// t and tc of the layer into d, and the cotangents d.ct_t and d.ct_tc
// added to those of the layer's gas and total absorptivities and of its
// cloud fraction (the last two only in a cloudy layer).
__device__ __forceinline__ void ddt_step_bwd(DdtStep& d, float at,
                                             float atot, float cf, bool cly,
                                             float& ct_at, float& ct_atot,
                                             float& ct_cf) {
    const float tg = 1.0f - at;
    d.t = cly ? cf * (1.0f - atot) + (1.0f - cf) * tg : tg;
    d.tc = tg;
    ct_at -= (cly ? d.ct_t * (1.0f - cf) : d.ct_t) + d.ct_tc;
    if (cly) {
        ct_atot -= d.ct_t * cf;
        ct_cf += d.ct_t * (at - atot);
    }
}

// The d/dT operands of K6 at idrv=1: ct (2, L+1, B) the cotangents of
// duflx_dt and duflxc_dt; lam (L, 140, B) a scratch the reverse up sweep
// writes and the reverse down sweep reads, at (l, g, b) the cotangent of
// the derivative leaving layer l upward (of the total-sky one, the clear
// twin's added: a clear-sky column has no cloud); clear's alone (the
// keeps_ddt modes read the derivatives K1 kept, and lam is null there).
struct Ddt {
    const float* ct;
    float* lam;
};

// One level of the maximum-random overlap recursion (rtrn._sweep_maxrand,
// rtrnmr.f90:591-615 down, 678-703 up).  In a cloudy layer (cly) the
// total-sky stream is the sum of a cloudy (cr) and a clear (kr)
// sub-stream that exchange a correction radiance (rr), restarted from the
// stream entering the layer where `ist` holds; fac are the layer's six
// overlap factors (clr1, clr2, cld1, cld2, cmb1, cmb2).  Elsewhere the
// clear recurrence runs and the sub-streams keep their values.  The clear
// twin is advance()'s.
__device__ __forceinline__ void advance_mr(float& rad, float& radc,
                                           float& cr, float& kr, float& rr,
                                           const Step& f, bool cly,
                                           bool twin, bool ist,
                                           const float* fac) {
    const float gs = f.at * f.src;
    float rn = rad + (f.src - rad) * f.at;
    if (cly) {
        const float c = f.cf;
        const float cr0 = ist ? c * rad : cr;
        const float kr0 = ist ? rad - c * rad : kr;
        const float rr0 = ist ? 0.0f : rr;
        const float ttot = 1.0f - f.atot;
        const float cldsrc = f.srctot * f.atot;
        const float cr1 = cr0 * ttot + c * cldsrc;
        const float kr1 = kr0 * (1.0f - f.at) + (1.0f - c) * gs;
        const float radmod = rr0 * (fac[0] * (1.0f - f.at) + fac[2] * ttot)
                             - fac[4] * gs + fac[5] * cldsrc;
        const float r = -radmod + fac[1] * (kr1 + radmod)
                        - fac[3] * (cr1 - radmod);
        cr = cr1 + r;
        kr = kr1 - r;
        rr = r;
        rn = cr1 + kr1;
    }
    radc = twin ? radc + (f.src - radc) * f.at : rn;
    rad = rn;
}


// A copy of x the compiler cannot see through.  The staging's and the
// reduction's per-thread offsets are the same at every level; computed
// from an opaque thread index they are recomputed at each level instead
// of being hoisted into registers held through the sweep.
__device__ __forceinline__ int opaque(int x) {
    int y;
    asm volatile("mov.b32 %0, %1;\n" : "=r"(y) : "r"(x));
    return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// the mbarrier's arrival of this thread, once its cp.async copies issued
// so far have landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const uint32_t a = smem_addr(bar);
    unsigned done = 0;
    while (!done) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(a), "r"(parity) : "memory");
    }
}

// Hopper's bulk tensor copies (TMA), for K6 in the banded, fused,
// cldf-odcld and maxrand modes (rtrn_bwd_g.cu, rtrn_bwd_mr.cu) and K1's
// gradient-step launch (rtrn_kernel.cuh, SAVE_BULK): one thread arms a
// slot's mbarrier with the bytes it expects and issues 2D tile copies
// from a tensor map (cuTensorMapEncodeTiled, below) into shared memory;
// the copies complete the barrier's transaction count as they land.  K1
// also stores tiles from shared memory to device memory so.

// the barriers' initialisation made visible to the copy engine
__device__ __forceinline__ void fence_mbarrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// order this thread's generic accesses of shared (global) memory before
// later bulk copies into (out of) it
__device__ __forceinline__ void fence_proxy_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async_global() {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// a plain arrival of this thread on the mbarrier
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// this thread's arrival, and `bytes` more expected by the current phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// the (x, y) box of tensor map `map` (in kernel parameter space) into
// shared memory at dst (128-byte aligned), completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            int x, int y, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(x), "r"(y), "r"(smem_addr(bar))
        : "memory");
}

// The bulk tensor stores of K1's gradient-step launch (rtrn_kernel.cuh,
// SAVE_BULK): the (x, y) box of tensor map `map` from shared memory at
// src (128-byte aligned), in this thread's current bulk group, with the
// L2 eviction priority `policy` (l2_policy); the box's elements outside
// the tensor are not written.
__device__ __forceinline__ void tma_store_2d(const void* map,
                                             const void* src, int x, int y,
                                             uint64_t policy) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::"
        "cache_hint [%0, {%2, %3}], [%1], %4;\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
           "r"(x), "r"(y), "l"(policy)
        : "memory");
}

// an L2 cache policy: evict first (the lines a store writes leave L2
// before others) or normal
__device__ __forceinline__ uint64_t l2_policy(bool evict_first) {
    uint64_t p;
    if (evict_first)
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                     : "=l"(p));
    else
        asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
                     : "=l"(p));
    return p;
}

// close this thread's current bulk group
__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until this thread's bulk groups have read their shared memory
// (READ) or completed
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
    if constexpr (READ)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    else
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Copy `rows` rows of `nvalid` elements of ES bytes, row r at
// src + r * stride bytes, into the (rows, KX) tile at dst.  vec: the rows
// are 16-byte aligned and the tile full, 16-byte copies; else element by
// element, by cp.async for 4-byte elements and through registers for
// narrower ones (made visible by the block barrier that precedes their
// first read).  Columns from nvalid on are left unwritten: the sweep
// reads column nvalid - 1 there.
template <int ES>
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* src, int rows,
                                      size_t stride, int nvalid, bool vec,
                                      int tid) {
    constexpr int RB = KX * ES;
    if (vec) {
        constexpr int CPR = RB / 16;
        for (int i = tid; i < rows * CPR; i += KT) {
            const int r = i / CPR, j = i - r * CPR;
            cp16(dst + r * RB + j * 16, src + r * stride + j * 16);
        }
    } else if constexpr (ES == 4) {
        for (int i = tid; i < rows * nvalid; i += KT) {
            const int r = i / nvalid, c = i - r * nvalid;
            cp4(dst + r * RB + c * 4, src + r * stride + c * 4);
        }
    } else {
        using E = std::conditional_t<ES == 2, uint16_t, uint8_t>;
        constexpr int BATCH = 8;
        const int n = rows * nvalid;
        for (int i0 = tid; i0 < n; i0 += KT * BATCH) {
            E v[BATCH];
#pragma unroll
            for (int j = 0; j < BATCH; ++j) {
                const int i = i0 + j * KT;
                if (i < n) {
                    const int r = i / nvalid, c = i - r * nvalid;
                    v[j] = *reinterpret_cast<const E*>(src + r * stride
                                                       + c * ES);
                }
            }
#pragma unroll
            for (int j = 0; j < BATCH; ++j) {
                const int i = i0 + j * KT;
                if (i < n) {
                    const int r = i / nvalid, c = i - r * nvalid;
                    *reinterpret_cast<E*>(dst + r * RB + c * ES) = v[j];
                }
            }
        }
    }
}

// can rows of ES-byte elements at `p`, `B` elements apart, go by 16 bytes
template <int ES>
__device__ __forceinline__ bool rows16(const void* p, int B) {
    return ((uintptr_t)p & 15u) == 0 && ((size_t)B * ES) % 16 == 0;
}

// can `p` start a tensor map's rows of B floats
inline bool map_rows_ok(const void* p, int B) {
    return ((uintptr_t)p & 15u) == 0 && B % 4 == 0;
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime so that
// the library does not link libcuda; null where it is missing.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        return e == cudaSuccess && q == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// A tensor map over `rows` rows of B floats (row r at base + r * B) whose
// boxes are box_cols x box_rows, out-of-range elements read as zero; the
// L2 fetches `l2` (promotion) around what a box row reads.  False where
// it cannot be encoded (base or B * 4 not a multiple of 16, no entry
// point).
inline bool tensor_map_rows(CUtensorMap* map, const float* base,
                            uint64_t rows, int B, int box_cols, int box_rows,
                            CUtensorMapL2promotion l2) {
    const EncodeTiled enc = encode_tiled();
    if (!enc) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)B, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)B * sizeof(float)};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t step[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
               const_cast<float*>(base), dims, strides, box, step,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               l2, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// let a kernel of this tile take `smem` bytes of dynamic shared memory,
// with the largest shared-memory carveout
template <typename Kernel>
cudaError_t tile_smem(Kernel* kernel, int smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
}

// out[0..7] = registers per thread, local memory bytes per thread (spill
// stack), static and dynamic shared memory bytes per block, blocks per
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the ring's levels,
// threads per block, columns per block of a KT-thread kernel launched
// with `smem` bytes of dynamic shared memory (its attributes set)
template <typename Kernel>
cudaError_t tile_info(Kernel* kernel, int smem, int ring, int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, KT,
                                                      smem);
    if (e != cudaSuccess) return e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = smem;
    out[4] = blocks;
    out[5] = ring;
    out[6] = KT;
    out[7] = KX;
    return cudaSuccess;
}

}  // namespace rt
}  // namespace rrtm
