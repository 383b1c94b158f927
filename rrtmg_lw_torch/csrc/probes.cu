// Probes of the card's row-selection rates: a one-hot selection product
// on the tensor cores and a row gather.
//
// Replace the archived Pallas probes of tools/archive/ (calib.py:31,
// chained_timing.py:45, diag_onehot.py:18, test_mxu_rate.py:19,
// test_onehot_cpu.py:18, test_pallas_onehot.py:18,
// test_timing_sanity.py:18: out = onehot(idx, R) @ tbl(R, D)[:, :Dout];
// test_pallas_gather.py:17: out = tbl(R, D)[idx]).  The TPU taumol chose
// one-hot products over gathers because its gathers were slow; these
// kernels measure both on the H100 (utils/probes.py times them), so that
// no TPU-shaped selection is carried over unmeasured.
//
// onehot_kernel: warp-level mma.sync m16n8k16, bf16 in, float32
// accumulate.  A block takes 256 rows x 64 columns of the output: the
// table's 64 columns, K = R rounded up to 16, sit in shared memory as
// NSPLIT bf16 planes (k contiguous, rows padded by 8 so that the B
// fragments' loads are free of bank conflicts); each of 8 warps builds
// the one-hot A fragments of its 32 rows in registers from the indices
// and runs 2 x 8 products per k-step.  NSPLIT = 1 selects bf16(tbl);
// NSPLIT = 3 ("exact") splits each float32 entry into hi + mid + lo bf16
// (the TPU taumol's nsplit, Precision.HIGHEST in calib.py:25), summed
// lo, mid, hi: every partial sum is a float32 number, so the result is
// tbl[idx] bit for bit.  Bound: bytes written (C x Dout floats).
//
// gather_kernel: one thread per output element, columns fastest, so
// reads of a table row and writes of an output row coalesce; the table
// (~110 KB) stays in L1 / L2.  Bound: bytes written.
#include <cuda_bf16.h>
#include <stdint.h>

#include "rrtm.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int MT = 2;                      // m16 tiles per warp
constexpr int BM = WARPS * MT * 16;        // output rows per block
constexpr int BN = 64;                     // output columns per block
constexpr int NT = BN / 8;                 // n8 tiles per warp
constexpr int KMAX = 128;                  // largest R
constexpr int KPADDING = 8;                // bf16 row padding in smem
constexpr int GATHER_THREADS = 256;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 of the one-hot row of index i at columns k (low half) and k+1
__device__ __forceinline__ uint32_t onehot2(int i, int k) {
    return (i == k ? 0x3F80u : 0u) | (i == k + 1 ? 0x3F800000u : 0u);
}

template <int NSPLIT>
__global__ void __launch_bounds__(WARPS * 32)
onehot_kernel(const int* __restrict__ idx, const float* __restrict__ tbl,
              float* __restrict__ out, int C, int R, int D, int dout,
              int kpad) {
    extern __shared__ __nv_bfloat16 planes[];  // (NSPLIT, BN, kpad + pad)
    const int ks = kpad + KPADDING;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    for (int i = threadIdx.x; i < BN * kpad; i += blockDim.x) {
        const int n = i % BN, k = i / BN;
        const float t = k < R && n0 + n < dout
                            ? tbl[(size_t)k * D + n0 + n] : 0.0f;
        const __nv_bfloat16 hi = __float2bfloat16_rn(t);
        planes[n * ks + k] = hi;
        if constexpr (NSPLIT > 1) {
            const float r1 = t - __bfloat162float(hi);
            const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
            planes[(BN + n) * ks + k] = mid;
            if constexpr (NSPLIT > 2) {
                const float r2 = r1 - __bfloat162float(mid);
                planes[(2 * BN + n) * ks + k] = __float2bfloat16_rn(r2);
            }
        }
    }
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    int id[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + (warp * MT + mt) * 16 + g + 8 * h;
            id[mt][h] = row < C ? idx[row] : -1;
        }
    float acc[MT][NT][4] = {};
    for (int p = NSPLIT - 1; p >= 0; --p) {             // lo, mid, hi
        const __nv_bfloat16* sp = planes + (size_t)p * BN * ks;
        for (int k0 = 0; k0 < kpad; k0 += 16) {
            uint32_t a[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                a[mt][0] = onehot2(id[mt][0], k0 + 2 * t);
                a[mt][1] = onehot2(id[mt][1], k0 + 2 * t);
                a[mt][2] = onehot2(id[mt][0], k0 + 2 * t + 8);
                a[mt][3] = onehot2(id[mt][1], k0 + 2 * t + 8);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const __nv_bfloat16* col = sp + (nt * 8 + g) * ks + k0 + 2 * t;
                const uint32_t b0 = *reinterpret_cast<const uint32_t*>(col);
                const uint32_t b1 =
                    *reinterpret_cast<const uint32_t*>(col + 8);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                    mma_bf16(acc[mt][nt], a[mt], b0, b1);
            }
        }
    }

    const bool pairs = (dout & 1) == 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int col = n0 + nt * 8 + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = m0 + (warp * MT + mt) * 16 + g + 8 * h;
                if (row >= C || col >= dout) continue;
                float* o = out + (size_t)row * dout + col;
                const float v0 = acc[mt][nt][2 * h];
                const float v1 = acc[mt][nt][2 * h + 1];
                if (pairs) {
                    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
                } else {
                    o[0] = v0;
                    if (col + 1 < dout) o[1] = v1;
                }
            }
        }
}

__global__ void __launch_bounds__(GATHER_THREADS)
gather_kernel(const int* __restrict__ idx, const float* __restrict__ tbl,
              float* __restrict__ out, int C, int R, int D) {
    const size_t i = (size_t)blockIdx.x * GATHER_THREADS + threadIdx.x;
    if (i >= (size_t)C * D) return;
    const int row = (int)(i / D), c = (int)(i % D);
    const int r = idx[row];
    out[i] = r >= 0 && r < R ? tbl[(size_t)r * D + c] : 0.0f;
}

template <int NSPLIT>
cudaError_t launch_onehot(const int* idx, const float* tbl, float* out, int C,
                          int R, int D, int dout, cudaStream_t s) {
    const int kpad = (R + 15) / 16 * 16;
    const size_t smem = (size_t)NSPLIT * BN * (kpad + KPADDING) * 2;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            onehot_kernel<NSPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return e;
    }
    const dim3 grid((C + BM - 1) / BM, (dout + BN - 1) / BN);
    onehot_kernel<NSPLIT><<<grid, WARPS * 32, smem, s>>>(idx, tbl, out, C, R,
                                                         D, dout, kpad);
    return cudaGetLastError();
}

}  // namespace

// idx (C,) int32 in [0, R) (other indices select a zero row); tbl (R, D)
// float32 -> out (C, dout) = onehot(idx, R) @ tbl[:, :dout], with the
// table as nsplit = 1 (bf16) or 3 (exact) bf16 planes; R <= 128.
RRTM_API int rrtm_probe_onehot(const int* idx, const float* tbl, float* out,
                               int C, int R, int D, int dout, int nsplit,
                               void* stream) {
    if (R < 1 || R > KMAX || dout > D) return (int)cudaErrorInvalidValue;
    if (C <= 0 || dout <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    if (nsplit == 1)
        return (int)launch_onehot<1>(idx, tbl, out, C, R, D, dout, s);
    if (nsplit == 3)
        return (int)launch_onehot<3>(idx, tbl, out, C, R, D, dout, s);
    return (int)cudaErrorInvalidValue;
}

// idx (C,) int32; tbl (R, D) float32 -> out (C, D) = tbl[idx] (rows whose
// index is outside [0, R) are zero; the table is never read outside).
RRTM_API int rrtm_probe_gather(const int* idx, const float* tbl, float* out,
                               int C, int R, int D, void* stream) {
    const size_t n = (size_t)C * D;
    if (C > 0 && D > 0) {
        const unsigned blocks =
            (unsigned)((n + GATHER_THREADS - 1) / GATHER_THREADS);
        gather_kernel<<<blocks, GATHER_THREADS, 0, (cudaStream_t)stream>>>(
            idx, tbl, out, C, R, D);
    }
    return (int)cudaGetLastError();
}
