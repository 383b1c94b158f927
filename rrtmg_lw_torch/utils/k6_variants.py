"""K6 (csrc/rtrn_bwd.cu) and variant copies of it against a parent
checkout's K6, on the card: bitwise equality and device times in turns.

    python -m rrtmg_lw_torch.utils.k6_variants --parent build/base \\
        [--variants NAME ...] [--out times.json]

Each source (the parent's ``csrc/rtrn_bwd.cu``, this checkout's, and
each named variant of ``VARIANTS``, written under ``build/``) is built
alone into a small library (K6 has no external symbol; one nvcc each,
all started together, beside the package's own build, which supplies
K1's radiances), so a variant costs seconds.  On
phase 3's inputs (``snapshot.sweep_inputs``, B=16384, L=60) and on K1's
edge cases (``snapshot.k1_edge_args``), clear and compact, every
library's outputs are held bitwise against the parent's, and against a
second run of its own; then each is timed with CUDA events (mean of 5
launches after one) in turns, parent, this, variants, variants, this,
parent.  The ``prof`` variant's per-phase clock sums (``rrtm_k6_dbg``,
clear then compact) are printed as shares.  Exits non-zero unless this
checkout's K6 is bitwise the parent's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import threading

import torch

PHASES = ("stage", "wait", "compute", "barrier A", "band", "barrier B",
          "unused", "other")

# Variants of this commit's K6, (old, new) replacements in
# csrc/rtrn_bwd.cu; a replacement that no longer applies raises.
VARIANTS = {
    # the cloud factors only where the g-point's gate holds (or at
    # od == 0.06, where the two branches differ): bitwise the same
    "gated": [
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
    ],
    # the down sweep does not read the up sweep's per-g cotangents of
    # taut and fracs (wrong outputs: what those reads cost)
    "nopart": [
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
    ],
    # the next step's rows staged in four parts over the first four
    # g-points instead of all at the top of the step
    "spread": [
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
    ],
    # per-phase clock sums of every warp's lane 0, read back by
    # rrtm_k6_dbg (instrumented: its times are not the kernel's)
    "prof": [
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
    ],
}


def build_all(srcs, out_dir):
    """{name: ctypes library} of each (source, include dir), built alone
    with the package's flags, all at once, beside the package's build."""
    from rrtmg_lw_torch import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    pkg = {}
    th = threading.Thread(target=lambda: pkg.update(r=_build.build()))
    th.start()
    jobs = {}
    for name, (src, inc) in srcs.items():
        lib = out_dir / f"{name}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(inc),
               "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        print(f"--- {name}: nvcc rc {proc.returncode}")
        for line in out.splitlines():
            if "Used" in line or "spill" in line or "error" in line:
                print("  " + line.strip())
        if proc.returncode:
            continue
        L = ctypes.CDLL(str(lib))
        L.rrtm_rt_bwd.argtypes = list(_build.SIGNATURES["rrtm_rt_bwd"])
        L.rrtm_rt_bwd.restype = ctypes.c_int
        if hasattr(L, "rrtm_k6_dbg"):
            L.rrtm_k6_dbg.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name] = L
    th.join()
    return libs


def run(lib, a, ct, rads):
    """K6 of ``lib`` on a (rt_sweep_vjp's first 11 arguments): its
    outputs, None-free, in rt_sweep_vjp's order."""
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


def cases(device):
    """[(tag, args, ct, rads)]: phase 3's inputs and K1's edge cases,
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
            out.append((f"{tag} {name}", a6, ct, rads))
    return out


def event_ms(fn, n=5):
    fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout holding the parent's rrtmg_lw_torch/")
    ap.add_argument("--variants", nargs="*", default=[],
                    choices=sorted(VARIANTS), help="variants to build too")
    ap.add_argument("--out", help="write the times here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k6_variants needs a CUDA device")
    root = pathlib.Path(__file__).resolve().parents[2]
    csrc = root / "rrtmg_lw_torch" / "csrc"
    pcsrc = pathlib.Path(args.parent).resolve() / "rrtmg_lw_torch" / "csrc"
    srcs = {"parent": (pcsrc / "rtrn_bwd.cu", pcsrc),
            "this": (csrc / "rtrn_bwd.cu", csrc)}
    out_dir = root / "build" / "k6_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in args.variants:
        text = (csrc / "rtrn_bwd.cu").read_text()
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name} no longer applies")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        srcs[name] = (out_dir / f"{name}.cu", csrc)
    libs = build_all(srcs, out_dir)
    from rrtmg_lw_torch.ops import rtrn_cuda
    dev = torch.device("cuda", 0)
    for cloudy in (False, True):
        print("k6_info", "compact" if cloudy else "clear",
              rtrn_cuda.k6_info(cloudy))
    cs = cases(dev)
    ok = True
    for tag, a6, ct, rads in cs:
        ref = run(libs["parent"], a6, ct, rads)
        pk = [g for g in rtrn_cuda.rt_sweep_vjp(*a6, ct, rads=rads)
              if g is not None]
        res = {"package": all(torch.equal(p, r) for p, r in zip(pk, ref))}
        for name, lib in libs.items():
            got, again = (run(lib, a6, ct, rads) for _ in range(2))
            res[name] = all(torch.equal(g, r) for g, r in zip(got, ref))
            res[name + " rerun"] = all(torch.equal(g, h)
                                       for g, h in zip(got, again))
        ok &= res["package"] and res["this"]
        print(tag, json.dumps(res), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    names = list(libs)
    times = {}
    for tag, a6, ct, rads in cs[:2]:
        for name in names + names[::-1]:
            t = event_ms(lambda: run(libs[name], a6, ct, rads))
            times.setdefault(tag, {}).setdefault(name, []).append(t)
        print(tag, "ms", json.dumps(times[tag]), flush=True)
    for name, lib in libs.items():
        if not hasattr(lib, "rrtm_k6_dbg"):
            continue
        buf = (ctypes.c_ulonglong * 16)()
        for tag, a6, ct, rads in cs[:2]:
            lib.rrtm_k6_dbg(buf, 1)
            run(lib, a6, ct, rads)
            torch.cuda.synchronize()
            lib.rrtm_k6_dbg(buf, 0)
            row = list(buf)[8:] if "compact" in tag else list(buf)[:8]
            print(name, tag, "clock shares", {
                p: round(x / sum(row), 4) for p, x in zip(PHASES, row)})
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            dict(device=smi, times=times), indent=1))
    print("k6_variants:", "this K6 bitwise the parent's" if ok
          else "this K6 DIFFERS from the parent's")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
