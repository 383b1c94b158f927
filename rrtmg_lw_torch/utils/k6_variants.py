"""K6 (csrc/rtrn_bwd.cu) and variant copies of it against a parent
checkout's K6, on the card: bitwise equality and device times in turns
(``utils/variants.py``, which says how).

    python -m rrtmg_lw_torch.utils.k6_variants --parent build/base \\
        [--variants NAME ...] [--out times.json]

The cases: phase 3's inputs (``snapshot.sweep_inputs``, B=16384, L=60)
and K1's edge cases (``snapshot.k1_edge_args``), clear and compact, with
K1's radiances from the package and seeded cotangents; the first two
(phase 3's, clear then compact) are timed.  The ``prof`` variant's
per-phase clock sums (``rrtm_k6_dbg``, clear then compact) are printed
as shares.
"""

from __future__ import annotations

import sys

import torch

from rrtmg_lw_torch.utils import variants

PHASES = ("stage", "wait", "compute", "barrier A", "band", "barrier B",
          "unused", "other")

# Variants of this commit's K6: (old, new) replacements in
# csrc/rtrn_bwd.cu, with the package's nvcc flags; a replacement that no
# longer applies raises.
VARIANTS = {
    # the cloud factors only where the g-point's gate holds (or at
    # od == 0.06, where the two branches differ): bitwise the same
    "gated": ([
        ("""        const float xt = od + odce;
        factors_d(xt, xt < 0.06f, atot, tft, datot, dtft);""",
         """        const float xt = od + odce;
        if (gate || od == 0.06f) {
            factors_d(xt, xt < 0.06f, atot, tft, datot, dtft);
        } else {
            atot = at; tft = tfg; datot = dat; dtft = dtfg;
        }"""),
        ("""        ecl = expf(-odce);""",
         """        ecl = gate ? expf(-odce) : 1.0f;"""),
    ], None),
    # the down sweep does not read the up sweep's per-g cotangents of
    # taut and fracs (wrong outputs: what those reads cost)
    "nopart": ([
        ("""                    pt[k] = gr.taut[gi];
                    pf[k] = gr.fracs[gi];
                }
            }""",
         """                    pt[k] = 0.0f;
                    pf[k] = 0.0f;
                }
            }"""),
        ("""                if constexpr (!UPW && CLOUDY) {
                    pt[k] = gr.taut[gi];
                    pf[k] = gr.fracs[gi];
                }""",
         """                if constexpr (!UPW && CLOUDY) {
                    pt[k] = 0.0f;
                    pf[k] = 0.0f;
                }"""),
    ], None),
    # the next step's rows staged in four parts over the first four
    # g-points instead of all at the top of the step
    "spread": ([
        ("""    auto stage_step = [&](int j) {
        const bool up = j < L;""",
         """    auto stage_step = [&](int j, int part = -1) {
        auto want = [&](int q) { return part < 0 || part == q; };
        const bool up = j < L;"""),
        ("""        rows(Sl::TAU, in.taut + gl, KG, Bz);
        rows(Sl::FR, in.fracs + gl, KG, Bz);
        // up: U (and Uc) entering l; down: D (and Dc) at level l+1
        if (up || l + 1 < L) {""",
         """        if (want(0)) rows(Sl::TAU, in.taut + gl, KG, Bz);
        if (want(1)) rows(Sl::FR, in.fracs + gl, KG, Bz);
        // up: U (and Uc) entering l; down: D (and Dc) at level l+1
        if (want(2) && (up || l + 1 < L)) {"""),
        ("""        rows(Sl::PLAY, in.play""",
         """        if (!want(3)) return;
        rows(Sl::PLAY, in.play"""),
        ("""        if (j + RING - 1 < 2 * L) stage_step(j + RING - 1);
        wait_step(j);""",
         """        const bool next = j + 1 < 2 * L;
        if (next && !valid) stage_step(j + 1);
        wait_step(j);"""),
        ("""            for (int k = 0; k < KGPT; ++k) {
                const int g = gy + k * KY;
                if (g >= KG) continue;""",
         """            for (int k = 0; k < KGPT; ++k) {
                if (next && k < 4) stage_step(j + 1, k);
                const int g = gy + k * KY;
                if (g >= KG) continue;"""),
    ], None),
    # per-phase clock sums of every warp's lane 0, read back by
    # rrtm_k6_dbg (instrumented: its times are not the kernel's)
    "prof": ([
        ("""constexpr int RING = 2;""",
         """__device__ unsigned long long k6_dbg[2][8];
constexpr int RING = 2;"""),
        ("""    float* ctsec_s = reinterpret_cast<float*>(smem + Lo::CTSEC);
""",
         """    float* ctsec_s = reinterpret_cast<float*>(smem + Lo::CTSEC);
    unsigned long long tacc[8] = {};
    long long tlast = clock64();
    auto tick = [&](int ph) {
        const long long t = clock64();
        tacc[ph] += (unsigned long long)(t - tlast);
        tlast = t;
    };
"""),
        ("""        if (j + RING - 1 < 2 * L) stage_step(j + RING - 1);
        wait_step(j);""",
         """        tick(7);
        if (j + RING - 1 < 2 * L) stage_step(j + RING - 1);
        tick(0);
        wait_step(j);
        tick(1);"""),
        ("""        __syncthreads();          // gp published""",
         """        tick(2);
        __syncthreads();          // gp published"""),
        ("""        float sq[NQ];
""",
         """        tick(3);
        float sq[NQ];
"""),
        ("""                ballot_step(j + 1);
            }
            __syncthreads();""",
         """                ballot_step(j + 1);
            }
            tick(4);
            __syncthreads();
            tick(5);"""),
        ("""    // ---- 4. surface reflection in reverse ----""",
         """    tick(7);
    // ---- 4. surface reflection in reverse ----"""),
        ("""    if (valid) gr.surf[(size_t)ty * Bz + b] = sq[0];
}""",
         """    if (valid) gr.surf[(size_t)ty * Bz + b] = sq[0];
    tick(7);
    if ((tid & 31) == 0)
        for (int i = 0; i < 8; ++i) atomicAdd(&k6_dbg[CLOUDY][i], tacc[i]);
}"""),
        ("""RRTM_API int rrtm_rt_bwd_info(int cloudy, int* out) {""",
         """RRTM_API int rrtm_k6_dbg(unsigned long long* out, int reset) {
    if (reset) {
        unsigned long long z[16] = {};
        return (int)cudaMemcpyToSymbol(k6_dbg, z, sizeof(z));
    }
    return (int)cudaMemcpyFromSymbol(out, k6_dbg, sizeof(k6_dbg));
}

RRTM_API int rrtm_rt_bwd_info(int cloudy, int* out) {"""),
    ], None),
}


def run(lib, case):
    """K6 of ``lib`` on a case (a: rt_sweep_vjp's first 11 arguments,
    ct, rads): its outputs, None-free, in rt_sweep_vjp's order."""
    a, ct, rads = case
    taut_t, fracs_t, play, plev, surf, cw, abi, abl, mask, ngb0, wg = a
    cloudy = mask is not None
    grads = [torch.empty_like(t) for t in (taut_t, fracs_t, play, plev,
                                           surf)]
    grads += [torch.empty_like(t) for t in (cw, abi, abl) if cloudy]
    ptrs = [t.data_ptr() if isinstance(t, torch.Tensor) else None
            for t in (taut_t, fracs_t, play, plev, surf, ngb0, wg, mask, cw,
                      abi, abl, ct, rads)]
    ptrs += [g.data_ptr() for g in grads] + [None] * (8 - len(grads))
    L, _, B = taut_t.shape
    err = lib.rrtm_rt_bwd(*ptrs, L, B, int(cloudy),
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rrtm_rt_bwd: error {err}")
    return grads


def package(case):
    """The package's K6 (``rt_sweep_vjp``) on a case, as ``run``."""
    from rrtmg_lw_torch.ops import rtrn_cuda
    a, ct, rads = case
    return [g for g in rtrn_cuda.rt_sweep_vjp(*a, ct, rads=rads)
            if g is not None]


def info(lib):
    """K6's launch configuration in ``lib``, clear and compact
    (``rtrn_cuda.K1_INFO``)."""
    from rrtmg_lw_torch.ops.rtrn_cuda import K1_INFO
    return {name: variants.lib_info(lib, "rrtm_rt_bwd_info", K1_INFO,
                                    cloudy)
            for cloudy, name in enumerate(("clear", "compact"))}


def cases(device):
    """[(tag, (args, ct, rads))]: phase 3's inputs and K1's edge cases,
    clear and compact, with K1's radiances and seeded cotangents."""
    from rrtmg_lw_torch.ops import rtrn, rtrn_cuda
    from rrtmg_lw_torch.utils import snapshot
    x = snapshot.sweep_inputs(device)
    args, model, sc, prof = x["args"], x["model"], x["sc"], x["prof"]
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm,
                          torch.float32)
    modes = snapshot.k1_cloud_args(device, x["static"], x["mc"])
    eargs, emodes, _ = snapshot.k1_edge_args(device, x["static"], args)
    gen = torch.Generator(device=device).manual_seed(5)
    out = []
    for tag, a, ms in (("main", args, modes), ("edge", eargs, emodes)):
        L, _, B = a[0].shape
        ct = torch.randn((4, L + 1, B), generator=gen, device=device)
        mask, cw, abi, abl = ms["compact"][1][0]
        for name, cf in (("clear", (None,) * 4),
                         ("compact", (cw, abi, abl, mask))):
            a6 = (*a[:4], surf, *cf, model.ngb0, model.wg)
            rads = rtrn_cuda.rt_sweep_radiances(*a6)[1]
            out.append((f"{tag} {name}", (a6, ct, rads)))
    return out


KERNEL = variants.Kernel(
    module="k6_variants", source="rtrn_bwd.cu", variants=VARIANTS,
    cases=cases, run=run, package=package, info=info,
    dbg="rrtm_k6_dbg", phases=PHASES,
    dbg_row=lambda tag: int("compact" in tag))


if __name__ == "__main__":
    sys.exit(variants.main(KERNEL, doc=__doc__))


