"""K6 in the banded, fused and cldf-odcld modes (csrc/rtrn_bwd_g.cu) and
variant copies of it against a parent checkout's, on the card: bitwise
equality and device times in turns (``utils/variants.py``, which says
how).

    python -m rrtmg_lw_torch.utils.k6g_variants --parent build/base \\
        [--variants NAME ...] [--out times.json]

The cases: phase 3's inputs (``snapshot.sweep_inputs``, B=16384, L=60)
with each mode's cell clouds (``snapshot.k1_cloud_args``: banded on
band_cloudy's, fused on mcica_blocked's, cldf-odcld on mcica_tauc's), and
K1's edge cases (``snapshot.k1_edge_args``) in the three modes, with K1's
radiances from the package and seeded cotangents; the three of phase 3
are timed.  Banded's cloud-fraction cotangent is summed over the band
groups in another order than the first design's: its largest difference
from the parent's is printed, and it is not held bitwise.  Each case's
outputs are allocated as the package's wrapper does (the ``fill``
variant's per-g cloud cotangents zeroed, the zeros it does not write),
so that a library's time includes the fill it needs.  The ``prof``
variant's per-phase clock sums (``rrtm_k6g_dbg``, each warp's lane 0, a
row per mode) are printed as shares.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from rrtmg_lw_torch.utils import variants

MODES = ("banded", "fused", "cldf_od")
PHASES = ("wait", "g-loop", "barrier", "band", "cloud adds", "release",
          "issue", "other", "flags")

# the prof variant's clock points: (anchor in the source, phase ending
# there); a tick inserted before each anchor
_TICKS = (
    ("        mbar_wait(&full[j % G_RING], (unsigned)(j / G_RING) & 1u);\n",
     None),
    ("        const bool cly = (flags[l] >> tx) & 1u;\n", 0),
    ("        __syncthreads();          // the per-g values published\n", 1),
    ("\n        // ---- the band sums: warp k, band b0 + k, in ascending g; "
     "the\n", 2),
    ("        // the down sweep adds the up sweep's per-g cloud cotangents "
     "of a\n", 3),
    ("        // the slot is free once every thread has arrived\n", 4),
)


def _prof():
    """The prof variant's replacements: clock() at each phase's end,
    summed per warp (lane 0) into k6g_dbg[mode][phase]."""
    reps = [
        ("constexpr int NCLD = 6; ",
         "__device__ unsigned long long k6g_dbg[3][9];\n"
         "constexpr int NCLD = 6; "),
        ("    const int tid = threadIdx.x;\n",
         "    unsigned tacc[9] = {};\n"
         "    unsigned tlast = (unsigned)clock();\n"
         "    auto tick = [&](int ph) {\n"
         "        const unsigned t = (unsigned)clock();\n"
         "        tacc[ph] += t - tlast;\n"
         "        tlast = t;\n"
         "    };\n"
         "    const int tid = threadIdx.x;\n"),
        ("    int hi = -1;                            // the highest cloudy "
         "layer\n",
         "    tick(8);\n"
         "    int hi = -1;                            // the highest cloudy "
         "layer\n"),
    ]
    for anchor, ph in _TICKS:
        reps.append((anchor, (f"        tick({ph});\n" if ph is not None
                              else "        tick(7);\n") + anchor))
    reps += [
        ("        mbar_arrive(&empty[j % G_RING]);\n    };\n",
         "        mbar_arrive(&empty[j % G_RING]);\n"
         "        tick(5);\n    };\n"),
        ("        if (j + 2 < L) issue(j + 2);\n",
         "        if (j + 2 < L) issue(j + 2);\n        tick(6);\n"),
        ("        if (j + 2 < 2 * L) issue(j + 2);\n",
         "        if (j + 2 < 2 * L) issue(j + 2);\n        tick(6);\n"),
        ("        gr.surf[(size_t)(b0 + ty) * Bz + b] = cs;\n    }\n",
         "        gr.surf[(size_t)(b0 + ty) * Bz + b] = cs;\n    }\n"
         "    tick(7);\n"
         "    if ((tid & 31) == 0)\n"
         "        for (int i = 0; i < 9; ++i)\n"
         "            atomicAdd(&k6g_dbg[MODE == BANDED ? 0 : MODE == FUSED"
         " ? 1 : 2][i],\n"
         "                      (unsigned long long)tacc[i]);\n"),
        ("RRTM_API int rrtm_rt_bwd_g_info(int mode, int L, int* out) {",
         "RRTM_API int rrtm_k6g_dbg(unsigned long long* out, int reset) {\n"
         "    if (reset) {\n"
         "        unsigned long long z[27] = {};\n"
         "        return (int)cudaMemcpyToSymbol(k6g_dbg, z, sizeof(z));\n"
         "    }\n"
         "    return (int)cudaMemcpyFromSymbol(out, k6g_dbg, "
         "sizeof(k6g_dbg));\n"
         "}\n\n"
         "RRTM_API int rrtm_rt_bwd_g_info(int mode, int L, int* out) {"),
    ]
    return reps


# Variants of this commit's K6-g: (old, new) replacements in
# csrc/rtrn_bwd_g.cu, with the package's nvcc flags; a replacement that
# no longer applies raises.
VARIANTS = {
    # per-phase clock sums (instrumented: its times are not the kernel's)
    "prof": (_prof(), None),
    # the tickets tile-major (a tile's five blocks consecutive) in place
    # of group-major: the blocks running together read five groups' rows
    # of fewer tiles
    "tilemajor": ([
        ("grp = tk / ntiles, tile = tk % ntiles;",
         "grp = tk % NGRP, tile = tk / NGRP;"),
    ], None),
    # the other way to the zeros: no zero stores, the caller zeroes the per-g
    # cloud cotangents (the library says so)
    "fill": ([
        ("        if constexpr (UPW && NCG > 0) {\n            for (int r = ty; "
         "r < nr; r += GY)\n                if (valid && !cly)",
         "        if constexpr (false) {\n            for (int r = ty; "
         "r < nr; r += GY)\n                if (valid && !cly)"),
        ("RRTM_API int rrtm_rt_bwd_g_info(int mode, int L, int* out) {",
         "RRTM_API int rrtm_rt_bwd_g_needs_zeros() { return 1; }\n\n"
         "RRTM_API int rrtm_rt_bwd_g_info(int mode, int L, int* out) {"),
    ], None),
    # no proxy fence before a slot's release (what the fence costs; the
    # copy engine's writes are then unordered against the threads' last
    # ones in principle)
    "nofence": ([
        ("        fence_proxy_async_smem();\n"
         "        mbar_arrive(&empty[j % G_RING]);\n",
         "        mbar_arrive(&empty[j % G_RING]);\n"),
    ], None),
}


def _scratch(lib, mode, L, B, words, device):
    """The pointers of ``lib``'s scratch arguments: a library that reads
    K1's cloudy-layer words (its scratch sizes three ints: count, tpart's
    blocks and floats) takes (words, count, tpart); one that forms them
    itself (four: count, tflags, tpart's) takes (count, tflags, tpart)."""
    from rrtmg_lw_torch.ops.rtrn_cuda import MODES as K1_MODES
    n = (ctypes.c_int * 4)(-1, -1, -1, -1)
    lib.rrtm_rt_bwd_g_scratch(K1_MODES[mode], L, B,
                              ctypes.cast(n, ctypes.c_void_p))
    count = torch.zeros(n[0], dtype=torch.int32, device=device)
    words_here = n[3] < 0
    npart = n[1] * n[2] if words_here else n[2] * n[3]
    part = torch.empty(npart, dtype=torch.float32, device=device)
    keep = [count, part]                # alive until the launch
    ptrs = [count.data_ptr(), part.data_ptr() if npart else None]
    if words_here:
        return [None if words is None else words.data_ptr()] + ptrs, keep
    flags = torch.empty(n[1], dtype=torch.int32, device=device)
    keep.append(flags)
    return [ptrs[0], flags.data_ptr() if n[1] else None, ptrs[1]], keep


def run(lib, case):
    """K6-g of ``lib`` on a case (mode, x (taut_t, fracs_t, planklay_t,
    planklev_t, surf), the mode's clouds, ngb0, wg, ct, rads, words): its
    outputs in ``rt_sweep_banded_vjp`` / ``rt_sweep_g_vjp``'s order."""
    from rrtmg_lw_torch.ops.rtrn_cuda import MODES as K1_MODES
    mode, x, clouds, ngb0, wg, ct, rads, words = case
    zero = hasattr(lib, "rrtm_rt_bwd_g_needs_zeros")
    grads = [torch.zeros_like(t) if zero and t.dim() == 3
             and t.shape[1] == 144 else torch.empty_like(t)
             for t in (*x, *clouds)]
    pad = [None] * (6 - len(clouds))
    ptrs = [t.data_ptr() for t in (*x, ngb0, wg, *clouds)] + pad
    ptrs += [ct.data_ptr(), rads.data_ptr()]
    ptrs += [g.data_ptr() for g in grads] + pad
    L, _, B = x[0].shape
    if hasattr(lib, "rrtm_rt_bwd_g_scratch"):
        sptrs, scratch = _scratch(lib, mode, L, B, words, x[0].device)
        ptrs += sptrs
    else:
        # a first-design library: no scratch (its entry's own signature)
        lib.rrtm_rt_bwd_g.argtypes = [ctypes.c_void_p] * 26 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
    err = lib.rrtm_rt_bwd_g(*ptrs, L, B, K1_MODES[mode],
                            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rrtm_rt_bwd_g: error {err}")
    return grads


def package(case):
    """The package's K6-g on a case, as ``run``."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    mode, x, clouds, ngb0, wg, ct, rads, words = case
    if mode == "banded":
        return list(rtrn_cuda.rt_sweep_banded_vjp(*x, *clouds, ngb0, wg, ct,
                                                  rads=rads))
    return list(rtrn_cuda.rt_sweep_g_vjp(*x, clouds, ngb0, wg, ct,
                                         rads=rads, words=words))


def info(lib):
    """K6-g's launch configuration in ``lib`` per mode at L=60
    (``rtrn_cuda.K1_INFO``)."""
    from rrtmg_lw_torch.ops.rtrn_cuda import K1_INFO
    from rrtmg_lw_torch.ops.rtrn_cuda import MODES as K1_MODES
    return {m: variants.lib_info(lib, "rrtm_rt_bwd_g_info", K1_INFO,
                                 K1_MODES[m], 60) for m in MODES}


def cases(device):
    """[(tag, case)]: the three modes on phase 3's inputs with their
    cells' clouds, then on K1's edge cases, with K1's radiances in the
    mode and its cloudy-layer words (``rtrn_cuda.rt_sweep_g_radiances``)
    and seeded cotangents."""
    from rrtmg_lw_torch.ops import rtrn, rtrn_cuda
    from rrtmg_lw_torch.utils import snapshot
    x = snapshot.sweep_inputs(device)
    args, model, sc, prof = x["args"], x["model"], x["sc"], x["prof"]
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm,
                          torch.float32)
    cell = snapshot.k1_cloud_args(device, x["static"], x["mc"])
    eargs, emodes, _ = snapshot.k1_edge_args(device, x["static"], args)
    gen = torch.Generator(device=device).manual_seed(5)
    out = []
    for tag, a, ms in (("main", args, cell), ("edge", eargs, emodes)):
        L, _, B = a[0].shape
        ct = torch.randn((4, L + 1, B), generator=gen, device=device)
        xs = (*a[:4], surf)
        for mode in MODES:
            cl = ms[mode][1]
            cl = tuple(cl) if mode == "banded" else tuple(cl[0])
            _, rads, words = rtrn_cuda.rt_sweep_g_radiances(
                mode, *xs, cl, model.ngb0, model.wg)
            out.append((f"{tag} {mode}", (mode, xs, cl, model.ngb0,
                                          model.wg, ct, rads, words)))
    return out


KERNEL = variants.Kernel(
    module="k6g_variants", source="rtrn_bwd_g.cu", variants=VARIANTS,
    cases=cases, run=run, package=package, info=info,
    dbg="rrtm_k6g_dbg", phases=PHASES,
    dbg_row=lambda tag: MODES.index(tag.split()[-1]), ntimed=3,
    loose=lambda tag, i: tag.endswith("banded") and i == 5)


if __name__ == "__main__":
    sys.exit(variants.main(KERNEL, doc=__doc__))
