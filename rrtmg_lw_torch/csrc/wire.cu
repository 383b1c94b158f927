// K9: the device side of the streaming wire format (parallel/wire.py).
//
// Replaces no Pallas kernel: in the JAX package the decoders are jnp
// inside the jitted step, which XLA fuses into a few elementwise loops
// (rrtmg_lw_tpu/parallel/wire.py:256-279, the sanitize guards of
// ``_decode`` :400-436, the mask unpack of ``decode_compact_clouds``
// :586-590).  Run op by op in eager PyTorch the same decode is ~8-10
// launches a coded channel, twice that with the guards: ~150-300 a step.
// Here one launch decodes every channel of a WireBatch.
//
// wire_decode_kernel: the channels come as a table in the kernel's
// parameters (``WireArgs``: per channel its kind, codes, output, refs,
// fallback, element count and row length, and the first block of each
// channel), so one grid covers them all, each block inside one channel.
// A thread decodes 8 consecutive elements: one 16-byte load of codes and
// two float4 (float) or four double2 (double) stores where the channel's
// pointers are 16-byte aligned, element by element at a ragged end.
// Uniform channels write their row out, zero channels zeros.  With
// SANITIZE, every block first checks its channel's refs (finite, lo <= hi;
// the (K,) row read by the block, one __syncthreads_or), then each
// element's value (finite, above the field's floor); a bad value takes
// the fallback (a row of the output type, or a constant) and clears its
// column's ok byte (a plain store of 0: every writer stores the same
// value).  No host sync: ``ok`` is set to 1 by the wrapper.
//
// The arithmetic is the plain twin's (wire.py ``_dec_*``) operation for
// operation in the output type T: the quantization step (hi - lo) / n in
// float32, as the JAX decoders on float32 refs; with -fmad=false no
// product is contracted.  logratio's exp is expf / exp (within 2 ulp of
// torch.exp), the other codecs are bitwise.
//
// wire_unpack_kernel: (L, nb, B) uint8 bits -> (L, 8 nb, B) int8 mask,
// bit k of byte j the g-point 8 j + k.  A thread takes 4 columns of one
// (layer, byte) row: one 32-bit load and eight 32-bit stores (one per
// g-point, a warp one 128-byte line) where B % 4 == 0, bytes elsewhere.
//
// Bound on the H100: bytes (2 B in, 4 or 8 B out an element; the unpack
// 1 B in, 8 B out a byte), a few operations an element.
#include <stdint.h>
#include <string.h>

#include "rrtm.cuh"

namespace {

constexpr int MAX_CH = 24;
constexpr int THREADS = 256;
constexpr int PER = 8;                 // elements a thread: 16 B of codes

enum Kind { ZERO = 0, UNIFORM = 1, LOGRATIO = 2, DELTA = 3, UNIT = 4,
            LINEAR = 5 };

// one channel, as ops/wire_cuda.py's WireChannel (ctypes) lays it out
struct WireChannel {
    const uint16_t* codes;             // (B, K) codes; null if none
    void* out;                         // (B, K) in T
    const float* ref;                  // (K,) reference or uniform row
    const float* lo;                   // 0-d range ends (coded but unit)
    const float* hi;
    const void* fallback;              // (K,) in T, or null: fill
    double fill;
    double floor;
    long long n;                       // B * K
    int row;                           // K
    int kind;
    int has_floor;
    int vec;                           // codes and out 16-byte aligned
};

struct WireArgs {
    WireChannel ch[MAX_CH];
    int start[MAX_CH + 1];             // first block of each channel
    int nch;
};

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ T decode(int kind, unsigned u, float ref,
                                    float lo, float step) {
    switch (kind) {
    case LOGRATIO: {
        const T r = (T)lo + ((T)u - (T)1) * (T)step;
        return u == 0 ? (T)0 : (T)ref * exp_t(r);
    }
    case DELTA:
        return ((T)ref + (T)lo) + (T)u * (T)step;
    case UNIT:
        return (T)u / (T)65535;
    case LINEAR:
        return (T)lo + (T)u * (T)step;
    case UNIFORM:
        return (T)ref;
    default:
        return (T)0;
    }
}

template <typename T, bool SANITIZE>
__device__ __forceinline__ T guard(const WireChannel& c, T x, int k,
                                   long long b, bool cok,
                                   unsigned char* ok) {
    if (SANITIZE && c.kind != ZERO) {
        const bool bad = !isfinite(x) || (c.has_floor && x <= (T)c.floor);
        if (bad || !cok) {
            x = c.fallback ? static_cast<const T*>(c.fallback)[k] : (T)c.fill;
            ok[b] = 0;
        }
    }
    return x;
}

template <typename T, bool SANITIZE>
__global__ void __launch_bounds__(THREADS)
wire_decode_kernel(const __grid_constant__ WireArgs a,
                   unsigned char* __restrict__ ok) {
    int ci = 0;
    while (ci + 1 < a.nch && (int)blockIdx.x >= a.start[ci + 1]) ++ci;
    const WireChannel& c = a.ch[ci];
    const int kind = c.kind, K = c.row;
    const bool ranged = kind == LOGRATIO || kind == DELTA || kind == LINEAR;
    const bool has_ref = kind == LOGRATIO || kind == DELTA || kind == UNIFORM;
    float lo = 0.0f, step = 0.0f;
    if (ranged) {
        lo = *c.lo;
        step = (*c.hi - lo) / (kind == LOGRATIO ? 65534.0f : 65535.0f);
    }
    bool cok = true;
    if (SANITIZE) {
        int bad = 0;
        if (has_ref)
            for (int k = threadIdx.x; k < K; k += blockDim.x)
                bad |= !isfinite(c.ref[k]);
        if (ranged && threadIdx.x == 0) {
            const float hi = *c.hi;
            bad |= !(isfinite(lo) && isfinite(hi) && hi >= lo);
        }
        cok = !__syncthreads_or(bad);
    }
    const long long e0 =
        ((long long)(blockIdx.x - a.start[ci]) * THREADS + threadIdx.x) * PER;
    if (e0 >= c.n) return;
    long long b = e0 / K;
    int k = (int)(e0 - b * K);
    T* out = static_cast<T*>(c.out);
    if (c.vec && e0 + PER <= c.n) {
        unsigned u[PER] = {};
        if (c.codes) {
            const uint4 w = *reinterpret_cast<const uint4*>(c.codes + e0);
            const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                u[2 * j] = words[j] & 0xFFFFu;
                u[2 * j + 1] = words[j] >> 16;
            }
        }
        T v[PER];
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            v[j] = guard<T, SANITIZE>(
                c, decode<T>(kind, u[j], has_ref ? c.ref[k] : 0.0f, lo, step),
                k, b, cok, ok);
            if (++k == K) { k = 0; ++b; }
        }
        if constexpr (sizeof(T) == 4) {
            float4* o = reinterpret_cast<float4*>(out + e0);
            o[0] = make_float4(v[0], v[1], v[2], v[3]);
            o[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
            double2* o = reinterpret_cast<double2*>(out + e0);
#pragma unroll
            for (int j = 0; j < PER / 2; ++j)
                o[j] = make_double2(v[2 * j], v[2 * j + 1]);
        }
        return;
    }
    for (int j = 0; j < PER && e0 + j < c.n; ++j) {
        const unsigned u = c.codes ? c.codes[e0 + j] : 0u;
        out[e0 + j] = guard<T, SANITIZE>(
            c, decode<T>(kind, u, has_ref ? c.ref[k] : 0.0f, lo, step), k, b,
            cok, ok);
        if (++k == K) { k = 0; ++b; }
    }
}

__global__ void __launch_bounds__(THREADS)
wire_unpack_kernel(const uint8_t* __restrict__ bits,
                   int8_t* __restrict__ mask, int rows, int nb, int B,
                   int vec) {
    const int B4 = (B + 3) / 4;
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long row = t / B4;      // layer * nb + byte
    if (row >= rows) return;
    const int b = (int)(t - row * B4) * 4;
    const long long l = row / nb, j = row % nb;
    const uint8_t* src = bits + row * B + b;
    int8_t* dst = mask + (l * nb * 8 + j * 8) * B + b;
    if (vec) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
        for (int k = 0; k < 8; ++k)
            *reinterpret_cast<uint32_t*>(dst + (long long)k * B) =
                (w >> k) & 0x01010101u;
        return;
    }
    for (int i = 0; i < 4 && b + i < B; ++i) {
        const unsigned v = src[i];
#pragma unroll
        for (int k = 0; k < 8; ++k)
            dst[(long long)k * B + i] = (int8_t)((v >> k) & 1u);
    }
}

template <typename T, bool SANITIZE>
void launch_decode(const WireArgs& a, unsigned char* ok, cudaStream_t s) {
    wire_decode_kernel<T, SANITIZE>
        <<<a.start[a.nch], THREADS, 0, s>>>(a, ok);
}

}  // namespace

RRTM_API int rrtm_wire_desc_size() { return (int)sizeof(WireChannel); }

// desc: nch WireChannel (host memory, copied into the launch's
// parameters); ok: (B,) bytes the guards clear (SANITIZE only).
RRTM_API int rrtm_wire_decode(const void* desc, int nch, int is_f64,
                              int sanitize, unsigned char* ok,
                              void* stream) {
    if (nch < 1 || nch > MAX_CH || (sanitize && ok == nullptr))
        return (int)cudaErrorInvalidValue;
    WireArgs a;
    memset(&a, 0, sizeof(a));
    memcpy(a.ch, desc, sizeof(WireChannel) * nch);
    a.nch = nch;
    const long long per_block = (long long)THREADS * PER;
    for (int c = 0; c < nch; ++c) {
        if (a.ch[c].n < 0 || a.ch[c].row < 1)
            return (int)cudaErrorInvalidValue;
        a.start[c + 1] =
            a.start[c] + (int)((a.ch[c].n + per_block - 1) / per_block);
    }
    if (a.start[nch] == 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    if (is_f64) {
        if (sanitize) launch_decode<double, true>(a, ok, s);
        else launch_decode<double, false>(a, ok, s);
    } else {
        if (sanitize) launch_decode<float, true>(a, ok, s);
        else launch_decode<float, false>(a, ok, s);
    }
    return (int)cudaGetLastError();
}

// bits (L, nb, B) uint8 -> mask (L, 8 nb, B) int8.
RRTM_API int rrtm_wire_unpack(const uint8_t* bits, int8_t* mask, int L,
                              int nb, int B, void* stream) {
    const long long threads = (long long)L * nb * ((B + 3) / 4);
    if (threads > 0) {
        const int vec = B % 4 == 0 && ((uintptr_t)bits % 4 == 0)
                        && ((uintptr_t)mask % 4 == 0);
        wire_unpack_kernel<<<(unsigned)((threads + THREADS - 1) / THREADS),
                             THREADS, 0, (cudaStream_t)stream>>>(
            bits, mask, L * nb, nb, B, vec);
    }
    return (int)cudaGetLastError();
}
