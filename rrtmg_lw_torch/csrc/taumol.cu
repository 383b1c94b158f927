// K2: gaseous optical depth (taug) and Planck fractions for all 16 bands.
//
// Replaces rrtmg_lw_tpu/ops/taumol_pallas.py::PallasTaumol._build.kernel.
// The TPU kernel fused setcoef, selected k-table rows with one-hot
// matmuls over bf16 splits inside 64-row pressure windows, and carried a
// window_ok flag: workarounds for slow gathers.  None of that is kept.
// The spec is the plain TaumolEngine (ops/taumol.py): this kernel reads
// the port's setcoef outputs, packed (NF, L, B) / (NI, L, B), and
// gathers directly from one flat float32 table buffer (~1 MB, resident
// in L2) described per (band, region) by an int32 descriptor that
// ops/taumol_cuda.py::pack_tables compiles from BAND_SPECS.
//
// Bound on the H100: bytes written.  Each cell writes 2 x 140 values
// (taug, fracs) against 44 words of inputs; the k-table reads stay in
// L1 / L2.  What the first design (one thread per (column, layer, band),
// every descriptor word read and branched on at run time) spent its time
// on was issue and latency, most of it in each (cell, band)'s setup, run
// 16 times per cell with 16 warps per SM to hide it.  Here:
//   * one block per (tile of TB columns, layer): the tile's 44 input rows
//     and all 32 descriptors are staged in shared memory first, every load
//     independent and coalesced (a cell's inputs leave DRAM once, not 16
//     times);
//   * each thread walks the 16 bands of its column; the structure of each
//     (band, region) (flags, counts, field indices, ng: the Shape tables
//     of taumol.cuh, generated from pack_tables) is compiled in, so the
//     setup (rows, eta weights, minor columns and bins, corr, the fraction
//     row) has no descriptor branch or field-index load left, and each
//     g-loop is built for its band's ng; table offsets, shapes and the float
//     constants still come from the descriptor given, and the wrapper
//     holds its structure words to the compiled ones (rrtm_taumol_shape);
//   * a table row (ng contiguous floats, ng even) is read 8 bytes a load
//     (pack_tables starts every table on 8 bytes; 16-byte loads where ng
//     is a multiple of 4 measured slower: more registers, fewer blocks
//     per SM);
//   * 80 registers, 6 blocks of 128 threads per SM: occupancy is what the
//     latency of the setup and of the gathers needs;
//   * columns are the fastest thread index, so every (L, 140, B) store is
//     coalesced.
// Each element is still summed in the plain version's order (key taps
// t = 0..3, self, foreign, minors in order, CFCs, corr, postscale).
//
// Storage (RRTMG_SPEC_DTYPE, spec.cuh): one instantiation per storage
// type; the reduced ones encode each element at the store (the Pallas
// kernel's _enc / write_out, taumol_pallas.py:866-884) and write half
// the bytes.
//
// Index exactness: jp and laytrop come in from setcoef (never a log
// here); the eta bins (trunc of computed floats) use the plain version's
// operation order and the library is built with -fmad=false, so no
// contracted FMA moves a bin.  Every clip of taumol.py:357-417 is kept.
#include <stdint.h>

#include "spec.cuh"
#include "taumol.cuh"

namespace {

using namespace rrtm::taumol;

constexpr int NBIN = 4;         // TaumolEngine.BIN_SLOTS
constexpr int TB = 128;         // columns per block, one thread each
constexpr int THREADS = TB;
constexpr int MIN_BLOCKS = 6;   // per SM, for __launch_bounds__
constexpr int TAB_ALIGN = 2;    // floats: pack_tables' table alignment
constexpr int VW = 2;           // floats a row load
constexpr int NDESC_ALL = rrtm::NBAND * 2 * NDESC;

// One cell of band BAND in region REGION (0 lower, 1 upper), the
// region's run-time descriptor D (shared memory); the cell's fields at
// fin[f * TB], iin[f * TB]; taug and fracs at tg[g * B], fr[g * B]; its
// eta bins in bin[0..3].
template <int SPEC, int BAND, int REGION, typename S>
__device__ __forceinline__ void cell_band(const int* D, const float* fin,
                                          const int* iin, const float* T,
                                          S* tg, S* fr, size_t B, int* bin) {
    using rrtm::spec_enc;
    auto F = [&](int f) { return fin[f * TB]; };
    auto I = [&](int f) { return iin[f * TB]; };
    constexpr int NG = sw<BAND, REGION>(D_NGB);
    static_assert(NG % VW == 0, "rows are read VW floats a load");

    if constexpr (sw<BAND, REGION>(D_ZERO) != 0) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
            tg[(size_t)g * B] = spec_enc<SPEC, true>(0.0f);
            fr[(size_t)g * B] = spec_enc<SPEC, false>(0.0f);
        }
        return;
    } else {
    constexpr bool LOWER = REGION == 0;
    const float scale = LOWER ? 8.0f : 4.0f;
    constexpr int NSP = sw<BAND, REGION>(D_NSP);
    const int jp = I(I_JP), jt = I(I_JT), jt1 = I(I_JT1);

    // --- key species: the clipped rows of every tap, eta weights ------
    constexpr int KEY1 = sw<BAND, REGION>(D_KEY1);
    constexpr int KEY2 = sw<BAND, REGION>(D_KEY2);
    constexpr bool ETA4 = sw<BAND, REGION>(D_ETA4) != 0;
    constexpr int NTAP = ETA4 ? 4 : 2;
    float speccomb = 0.0f, speccomb1 = 0.0f;
    float w0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float w1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int k0[4] = {0, 0, 0, 0}, kb0[4] = {0, 0, 0, 0};
    int k1[4] = {0, 0, 0, 0}, kb1[4] = {0, 0, 0, 0};
    if constexpr (KEY1 >= 0) {
        const float colk1 = F(KEY1);
        int js0 = 0, js1 = 0;
        float fs = 0.0f, fs1 = 0.0f;
        float specparm = 0.5f, specparm1 = 0.5f;
        if constexpr (KEY2 >= 0) {
            const float colk2 = F(KEY2);
            const Eta e0 = eta_params(colk1, colk2,
                                      F(sw<BAND, REGION>(D_RAT0)), scale);
            const Eta e1 = eta_params(colk1, colk2,
                                      F(sw<BAND, REGION>(D_RAT1)), scale);
            speccomb = e0.speccomb;
            specparm = e0.specparm;
            js0 = e0.js;
            fs = e0.fs;
            speccomb1 = e1.speccomb;
            specparm1 = e1.specparm;
            js1 = e1.js;
            fs1 = e1.fs;
            bin[0] = js0;
            bin[1] = js1;
        } else {
            speccomb = speccomb1 = colk1;
        }
        int row0, row1;
        if constexpr (LOWER) {
            row0 = (jp * 5 + jt) * NSP + js0;
            row1 = ((jp + 1) * 5 + jt1) * NSP + js1;
        } else {
            const int na = D[D_NA];
            row0 = na + ((jp - 12) * 5 + jt) * NSP + js0;
            row1 = na + ((jp - 11) * 5 + jt1) * NSP + js1;
        }
        int tap0;
        if constexpr (ETA4) {
            spec_weights(specparm, fs, w0);
            spec_weights(specparm1, fs1, w1);
            tap0 = -1;
        } else {
            w0[0] = 1.0f - fs;
            w0[1] = fs;
            w1[0] = 1.0f - fs1;
            w1[1] = fs1;
            tap0 = 0;
        }
        const int nrow = D[D_NROW];
        constexpr int TOFF = NSP > 1 ? NSP : 1;  // temperature(+1) stride
        const int abs_off = D[D_ABS_OFF];
#pragma unroll
        for (int t = 0; t < NTAP; ++t) {
            int r = rrtm::clampi(row0 + tap0 + t, 0, nrow - 1);
            k0[t] = abs_off + r * NG;
            kb0[t] = abs_off + rrtm::clampi(r + TOFF, 0, nrow - 1) * NG;
            r = rrtm::clampi(row1 + tap0 + t, 0, nrow - 1);
            k1[t] = abs_off + r * NG;
            kb1[t] = abs_off + rrtm::clampi(r + TOFF, 0, nrow - 1) * NG;
        }
    }
    const float fac00 = F(F_FAC00), fac10 = F(F_FAC10);
    const float fac01 = F(F_FAC01), fac11 = F(F_FAC11);

    // --- continuum -----------------------------------------------------
    constexpr bool SELF = sw<BAND, REGION>(D_SELF_OFF) >= 0;
    constexpr bool FOR = sw<BAND, REGION>(D_FOR_OFF) >= 0;
    float selffac = 0.0f, selffrac = 0.0f, forfac = 0.0f, forfrac = 0.0f;
    int s_lo = 0, s_hi = 0, f_lo = 0, f_hi = 0;
    if constexpr (SELF) {
        const int self_off = D[D_SELF_OFF], indself = I(I_INDSELF);
        selffac = F(F_SELFFAC);
        selffrac = F(F_SELFFRAC);
        s_lo = self_off + indself * NG;
        s_hi = self_off + (indself + 1) * NG;
    }
    if constexpr (FOR) {
        const int for_off = D[D_FOR_OFF], indfor = I(I_INDFOR);
        forfac = F(F_FORFAC);
        forfrac = F(F_FORFRAC);
        f_lo = for_off + indfor * NG;
        f_hi = for_off + min(indfor + 1, 3) * NG;
    }

    // --- minor gases: per-cell column, rows and eta bin ----------------
    constexpr int NMINOR = sw<BAND, REGION>(D_NMINOR);
    const int im = I(I_INDMINOR);
    const int im1 = min(im + 1, 18);
    const float minorfrac = F(F_MINORFRAC);
    float colm[MAX_MINORS] = {0.0f, 0.0f, 0.0f};
    float fm[MAX_MINORS] = {0.0f, 0.0f, 0.0f};
    int ma[MAX_MINORS] = {0, 0, 0}, mb[MAX_MINORS] = {0, 0, 0};
    auto minor_setup = [&](auto ic) {
        constexpr int i = decltype(ic)::value;
        if constexpr (i < NMINOR) {
            constexpr int W = i * MINOR_WORDS;      // word offset of minor i
            const int* M = D + W;
            constexpr int ADJ_GAS = sw<BAND, REGION>(D_M0_ADJ_GAS + W);
            if constexpr (ADJ_GAS >= 0) {
                // over-abundance adjustment, chi_mls(gas, jp+1) reference
                const float colgas = F(ADJ_GAS);
                const float coldry = F(F_COLDRY);
                float chiref;
                if constexpr (sw<BAND, REGION>(D_M0_ADJ_CHI + W) >= 0)
                    chiref = T[M[D_M0_ADJ_CHI] + jp + 1];
                else
                    chiref = bits(M[D_M0_ADJ_CHICONST]);
                const float ratio = 1.0e20f * colgas / (coldry * chiref);
                const float thresh = bits(M[D_M0_ADJ_THRESH]);
                const float base = bits(M[D_M0_ADJ_BASE]);
                const float expnt = bits(M[D_M0_ADJ_EXPNT]);
                const float excess = ratio > thresh ? ratio - base : 1.0f;
                const float adjfac = base + powf(excess, expnt);
                const float adjcol = adjfac * chiref * coldry * 1.0e-20f;
                colm[i] = ratio > thresh ? adjcol : colgas;
            } else {
                constexpr int COLA = sw<BAND, REGION>(D_M0_COLA + W);
                constexpr int COLB = sw<BAND, REGION>(D_M0_COLB + W);
                if constexpr (COLB >= 0)
                    colm[i] = F(COLA) * F(COLB);
                else
                    colm[i] = F(COLA);
            }
            const int moff = M[D_M0_OFF];
            if constexpr (sw<BAND, REGION>(D_M0_KIND + W) != 0) {  // eta
                const Eta e = eta_params(
                    F(sw<BAND, REGION>(D_M0_REF_G1 + W)),
                    F(sw<BAND, REGION>(D_M0_REF_G2 + W)),
                    bits(M[D_M0_REFRAT]), scale);
                const int nk = M[D_M0_NK];
                const int jm0 = rrtm::clampi(e.js, 0, nk - 2);
                fm[i] = e.fs;
                if (bin[3] < 0) bin[3] = jm0;
                ma[i] = moff + (im * nk + jm0) * NG;
                mb[i] = moff + (im1 * nk + jm0) * NG;
            } else {
                ma[i] = moff + im * NG;
                mb[i] = moff + im1 * NG;
            }
        }
    };
    static_assert(MAX_MINORS == 3, "three minor_setup calls");
    minor_setup(Int<0>{});
    minor_setup(Int<1>{});
    minor_setup(Int<2>{});

    // --- CFCs, pressure correction, rescale, Planck fractions ---------
    constexpr int NCFC = sw<BAND, REGION>(D_NCFC);
    static_assert(MAX_CFCS == 2, "two CFC words");
    float wx[MAX_CFCS] = {0.0f, 0.0f};
    int coff[MAX_CFCS] = {0, 0};
    if constexpr (NCFC > 0) {
        wx[0] = F(sw<BAND, REGION>(D_C0_WX));
        coff[0] = D[D_C0_OFF];
    }
    if constexpr (NCFC > 1) {
        wx[1] = F(sw<BAND, REGION>(D_C1_WX));
        coff[1] = D[D_C1_OFF];
    }
    constexpr int CORR = sw<BAND, REGION>(D_CORR);
    float corr = 1.0f;
    if constexpr (CORR != 0) {
        const float pp = F(F_PAVEL);
        if constexpr (CORR == 1)
            corr = pp < 250.0f ? 1.0f - 0.15f * (250.0f - pp) / 154.4f
                               : 1.0f;
        else if constexpr (CORR == 2)
            corr = 1.0f - 0.15f * (pp / 95.6f);
        else
            corr = 1.0f - 0.05f * (pp - 100.0f) / 900.0f;
    }
    constexpr bool POST = sw<BAND, REGION>(D_POST_OFF) >= 0;
    const int post_off = POST ? D[D_POST_OFF] : 0;
    constexpr bool FRAC_ETA = sw<BAND, REGION>(D_FRAC_ETA) != 0;
    int foff = D[D_FRAC_OFF];
    float fpl = 0.0f;
    if constexpr (FRAC_ETA) {
        const Eta e = eta_params(F(sw<BAND, REGION>(D_FRAC_G1)),
                                 F(sw<BAND, REGION>(D_FRAC_G2)),
                                 bits(D[D_FRAC_REFRAT]), scale);
        const int jpl0 = rrtm::clampi(e.js, 0, D[D_FRAC_NROW] - 2);
        fpl = e.fs;
        foff += jpl0 * NG;
        bin[2] = jpl0;
    }

    // --- the g-points, VW at a time -----------------------------------
#pragma unroll 1
    for (int g = 0; g < NG; g += VW) {
        float tau[VW], x[VW], y[VW];
#pragma unroll
        for (int v = 0; v < VW; ++v) tau[v] = 0.0f;
        if constexpr (KEY1 >= 0) {
            float acc0[VW], acc1[VW], u[VW], z[VW];
#pragma unroll
            for (int v = 0; v < VW; ++v) acc0[v] = acc1[v] = 0.0f;
#pragma unroll
            for (int t = 0; t < NTAP; ++t) {
                load_row(T + k0[t] + g, x);
                load_row(T + kb0[t] + g, y);
                load_row(T + k1[t] + g, u);
                load_row(T + kb1[t] + g, z);
#pragma unroll
                for (int v = 0; v < VW; ++v) {
                    acc0[v] = acc0[v] + w0[t] * (fac00 * x[v] + fac10 * y[v]);
                    acc1[v] = acc1[v] + w1[t] * (fac01 * u[v] + fac11 * z[v]);
                }
            }
#pragma unroll
            for (int v = 0; v < VW; ++v)
                tau[v] = speccomb * acc0[v] + speccomb1 * acc1[v];
        }
        if constexpr (SELF) {
            load_row(T + s_lo + g, x);
            load_row(T + s_hi + g, y);
#pragma unroll
            for (int v = 0; v < VW; ++v)
                tau[v] = tau[v] + selffac * (x[v] + selffrac * (y[v] - x[v]));
        }
        if constexpr (FOR) {
            load_row(T + f_lo + g, x);
            load_row(T + f_hi + g, y);
#pragma unroll
            for (int v = 0; v < VW; ++v)
                tau[v] = tau[v] + forfac * (x[v] + forfrac * (y[v] - x[v]));
        }
        auto minor_term = [&](auto ic) {
            constexpr int i = decltype(ic)::value;
            if constexpr (i < NMINOR) {
                float absm[VW];
                load_row(T + ma[i] + g, x);
                load_row(T + mb[i] + g, y);
                if constexpr (sw<BAND, REGION>(D_M0_KIND + i * MINOR_WORDS)
                              != 0) {
                    float x1[VW], y1[VW];
                    load_row(T + ma[i] + NG + g, x1);
                    load_row(T + mb[i] + NG + g, y1);
#pragma unroll
                    for (int v = 0; v < VW; ++v) {
                        const float a1 = x[v] + fm[i] * (x1[v] - x[v]);
                        const float a2 = y[v] + fm[i] * (y1[v] - y[v]);
                        absm[v] = a1 + minorfrac * (a2 - a1);
                    }
                } else {
#pragma unroll
                    for (int v = 0; v < VW; ++v)
                        absm[v] = x[v] + minorfrac * (y[v] - x[v]);
                }
#pragma unroll
                for (int v = 0; v < VW; ++v)
                    tau[v] = tau[v] + colm[i] * absm[v];
            }
        };
        minor_term(Int<0>{});
        minor_term(Int<1>{});
        minor_term(Int<2>{});
#pragma unroll
        for (int c = 0; c < NCFC; ++c) {
            load_row(T + coff[c] + g, x);
#pragma unroll
            for (int v = 0; v < VW; ++v) tau[v] = tau[v] + wx[c] * x[v];
        }
        if constexpr (CORR != 0) {
#pragma unroll
            for (int v = 0; v < VW; ++v) tau[v] = corr * tau[v];
        }
        if constexpr (POST) {
            load_row(T + post_off + g, x);
#pragma unroll
            for (int v = 0; v < VW; ++v) tau[v] = tau[v] * x[v];
        }
        load_row(T + foff + g, x);
        if constexpr (FRAC_ETA) {
            load_row(T + foff + NG + g, y);
#pragma unroll
            for (int v = 0; v < VW; ++v) x[v] = x[v] + fpl * (y[v] - x[v]);
        }
#pragma unroll
        for (int v = 0; v < VW; ++v) {
            tg[(g + v) * B] = spec_enc<SPEC, true>(tau[v]);
            fr[(g + v) * B] = spec_enc<SPEC, false>(x[v]);
        }
    }
    }
}

// Bands BAND..15 of one cell: each in its region's instantiation (a warp
// whose columns straddle laytrop runs both), then its bins.
template <int SPEC, int BAND, typename S>
__device__ __forceinline__ void bands_from(bool lower, const int* sdesc,
                                           const float* fin, const int* iin,
                                           const float* T, S* tg, S* fr,
                                           size_t B, int* bins, size_t LB) {
    constexpr int GOFF = sw<BAND, 0>(D_GOFF);
    static_assert(GOFF == sw<BAND, 1>(D_GOFF), "regions share g offsets");
    int bin[NBIN] = {-1, -1, -1, -1};   // key_jp, key_jp1, frac, minor
    if (lower)
        cell_band<SPEC, BAND, 0>(sdesc + (BAND * 2) * NDESC, fin, iin, T,
                                 tg + GOFF * B, fr + GOFF * B, B, bin);
    else
        cell_band<SPEC, BAND, 1>(sdesc + (BAND * 2 + 1) * NDESC, fin, iin,
                                 T, tg + GOFF * B, fr + GOFF * B, B, bin);
    if (bins != nullptr) {
#pragma unroll
        for (int s = 0; s < NBIN; ++s)
            bins[(size_t)(BAND * NBIN + s) * LB] = bin[s];
    }
    if constexpr (BAND + 1 < rrtm::NBAND)
        bands_from<SPEC, BAND + 1>(lower, sdesc, fin, iin, T, tg, fr, B,
                                   bins, LB);
}

// SPEC: the storage of taug and fracs (spec.cuh); the float32
// instantiation stores as it always did
template <int SPEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
taumol_kernel(const float* __restrict__ fld, const int* __restrict__ ifld,
              const float* __restrict__ T, const int* __restrict__ desc,
              typename rrtm::SpecType<SPEC>::T* __restrict__ taug,
              typename rrtm::SpecType<SPEC>::T* __restrict__ fracs,
              int* __restrict__ bins, int L, int B) {
    __shared__ float sfld[NF * TB];            // (NF, TB)
    __shared__ int sifld[NI * TB];             // (NI, TB)
    __shared__ int sdesc[NDESC_ALL];           // (16, 2, NDESC)
    const int c = threadIdx.x;
    const int b0 = blockIdx.x * TB;
    const int l = blockIdx.y;
    const int nb = min(TB, B - b0);            // columns of this tile
    const size_t LB = (size_t)L * B;
    const size_t cell0 = (size_t)l * B + b0;

    for (int i = c; i < NDESC_ALL; i += THREADS) sdesc[i] = desc[i];
    for (int i = c; i < (NF + NI) * TB; i += THREADS) {
        const int f = i / TB, k = i % TB;
        if (k >= nb) continue;
        if (f < NF) sfld[i] = fld[f * LB + cell0 + k];
        else sifld[i - NF * TB] = ifld[(f - NF) * LB + cell0 + k];
    }
    __syncthreads();
    if (c >= nb) return;

    const int* iin = sifld + c;
    const size_t out = (size_t)l * rrtm::NGPT * B + b0 + c;
    bands_from<SPEC, 0>(iin[I_LAYTROP * TB] != 0, sdesc, sfld + c, iin, T,
                        taug + out, fracs + out, (size_t)B,
                        bins == nullptr ? nullptr : bins + cell0 + c, LB);
}

template <int SPEC>
cudaError_t launch(const float* fld, const int* ifld, const float* tabs,
                   const int* desc, void* taug, void* fracs, int* bins, int L,
                   int B, cudaStream_t s) {
    using T = typename rrtm::SpecType<SPEC>::T;
    if (reinterpret_cast<uintptr_t>(tabs) % (TAB_ALIGN * 4) != 0)
        return cudaErrorMisalignedAddress;
    const dim3 grid((B + TB - 1) / TB, L);
    taumol_kernel<SPEC><<<grid, THREADS, 0, s>>>(
        fld, ifld, tabs, desc, static_cast<T*>(taug), static_cast<T*>(fracs),
        bins, L, B);
    return cudaGetLastError();
}

// out[0..6] = registers per thread, local memory bytes per thread (spill
// stack), static and dynamic shared memory bytes per block, blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads per block,
// columns per block
template <int SPEC>
cudaError_t info(int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, taumol_kernel<SPEC>);
    if (e != cudaSuccess) return e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, taumol_kernel<SPEC>, THREADS, 0);
    if (e != cudaSuccess) return e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = 0;
    out[4] = blocks;
    out[5] = THREADS;
    out[6] = TB;
    return cudaSuccess;
}

// Shape<BR / 2, BR % 2>::w and those after it into out[BR * NDESC ...]
template <int BR>
void copy_shapes(int* out) {
    if constexpr (BR < rrtm::NBAND * 2) {
        for (int i = 0; i < NDESC; ++i)
            out[BR * NDESC + i] = Shape<BR / 2, BR % 2>::w[i];
        copy_shapes<BR + 1>(out);
    }
}

}  // namespace

RRTM_API int rrtm_taumol_ndesc() { return NDESC; }

// fld (NF, L, B) f32; ifld (NI, L, B) i32; tabs flat f32, every table
// starting on TAB_ALIGN floats (pack_tables); desc (16, 2, NDESC) i32,
// whose BAND_SPECS words must be the compiled Shape's (the wrapper
// holds them to rrtm_taumol_shape) -> taug, fracs (L, 140, B) in
// storage `spec` (spec.cuh: float32, bfloat16, float16 or logu16
// codes); bins (16, 4, L, B) i32 or null.
RRTM_API int rrtm_taumol(const float* fld, const int* ifld, const float* tabs,
                         const int* desc, void* taug, void* fracs,
                         int* bins, int L, int B, int spec, void* stream) {
    if (L <= 0 || B <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    switch (spec) {
    case rrtm::SPEC_F32:
        return (int)launch<rrtm::SPEC_F32>(fld, ifld, tabs, desc, taug,
                                           fracs, bins, L, B, s);
    case rrtm::SPEC_BF16:
        return (int)launch<rrtm::SPEC_BF16>(fld, ifld, tabs, desc, taug,
                                            fracs, bins, L, B, s);
    case rrtm::SPEC_F16:
        return (int)launch<rrtm::SPEC_F16>(fld, ifld, tabs, desc, taug,
                                           fracs, bins, L, B, s);
    case rrtm::SPEC_LOGU16:
        return (int)launch<rrtm::SPEC_LOGU16>(fld, ifld, tabs, desc, taug,
                                              fracs, bins, L, B, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

// K2's launch configuration in storage `spec` (the `info` words above)
RRTM_API int rrtm_taumol_info(int spec, int* out) {
    switch (spec) {
    case rrtm::SPEC_F32: return (int)info<rrtm::SPEC_F32>(out);
    case rrtm::SPEC_BF16: return (int)info<rrtm::SPEC_BF16>(out);
    case rrtm::SPEC_F16: return (int)info<rrtm::SPEC_F16>(out);
    case rrtm::SPEC_LOGU16: return (int)info<rrtm::SPEC_LOGU16>(out);
    default: return (int)cudaErrorInvalidValue;
    }
}

// out (16, 2, NDESC) i32: the descriptor words K2 compiled in (Shape), as
// ops/taumol_cuda.py::shape_words gives them
RRTM_API int rrtm_taumol_shape(int* out) {
    copy_shapes<0>(out);
    return 0;
}
