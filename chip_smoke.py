#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch/CUDA port (``rrtmg_lw_torch``).

Run from the repository root on a machine with one CUDA GPU (Hopper,
sm_90a):

    python3 chip_smoke.py

Phases, each raising on failure (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the four CUDA kernels from csrc/, timed;
  3. each kernel against its plain PyTorch version on the card at the
     main-path shapes (B=16384 columns, L=60 layers, float32), with the
     max error and CUDA-event times of both;
  4. end to end: clear sky and McICA (compact int8-mask clouds), 3 steps
     each through the kernels, launch counters reset just before and
     read just after; fluxes held against the same model run with
     impl="eager" on the card;
  5. deep: one McICA step at L=140 with the same checks.
The last two lines of stdout are the kernels' JSON summary and
{"ok": true, "device": {...}}.  Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

B_MAIN, L_MAIN, L_DEEP, STEPS = 16384, 60, 140, 3
# tolerances of the TPU port's on-chip gates (tools/tpu_verify.py:97,
# ROADMAP.md:17), kept
TOL_TABLE = 1e-6        # K3, K4: max |kernel - plain| / max |plain|
TOL_TAUMOL = 3.05e-5    # K2: taug relative (|ref| floored at 1e-2), fracs abs
TOL_FLUX = 2e-5         # K1 / model: per column, / max(max |flux|, 1)

KERNELS = (  # name, source, replaced TPU kernel
    ("taumol", "rrtmg_lw_torch/csrc/taumol.cu",
     "rrtmg_lw_tpu/ops/taumol_pallas.py:1068"),
    ("planck", "rrtmg_lw_torch/csrc/planck.cu",
     "rrtmg_lw_tpu/ops/planck_pallas.py:47"),
    ("cldcoef", "rrtmg_lw_torch/csrc/cldcoef.cu",
     "rrtmg_lw_tpu/ops/cldcoef_pallas.py:43"),
    ("rt_sweep", "rrtmg_lw_torch/csrc/rtrn.cu",
     "rrtmg_lw_tpu/ops/rtrn_pallas.py:140"),
)


def need(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    need(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def flux_err(a, b):
    """max over columns of max |a - b| / max(max |a|, 1), for (.., B)
    arrays with columns last."""
    a, b = a.double(), b.double()
    diff = (a - b).abs().flatten(0, -2).amax(0)
    scale = a.abs().flatten(0, -2).amax(0).clamp(min=1.0)
    return float((diff / scale).max())


def inputs(nlay, device):
    from rrtmg_lw_torch import Atmosphere, McicaCloudsCompact
    from rrtmg_lw_torch.utils.synthetic import (make_atmosphere,
                                                make_mcica_clouds)
    atm = Atmosphere.from_numpy(make_atmosphere(B_MAIN, nlay, seed=0),
                                device, torch.float32)
    clouds = McicaCloudsCompact.from_numpy(
        make_mcica_clouds(B_MAIN, nlay, seed=2, mask_dtype=np.int8),
        device, torch.float32)
    return atm, clouds


def phase_kernels(device):
    """Each kernel vs its plain version at the main-path shapes."""
    from rrtmg_lw_torch import LWConfig, make_model
    from rrtmg_lw_torch.ops import cldprop, rtrn
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_blocked
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.ops.planck_cuda import planck_interp_blocked
    from rrtmg_lw_torch.ops.rtrn_cuda import rt_fluxes_blocked
    from rrtmg_lw_torch.ops.setcoef import interp_planck_blocked, setcoef
    from rrtmg_lw_torch.ops.taumol_cuda import NBIN, taumol_blocked

    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False, impl="cuda"), device=device)
    atm, clouds = inputs(L_MAIN, device)
    prof = inatm(atm, dtype=torch.float32)
    static = model.static_tensors()
    sc = setcoef(prof, static, planck=False)
    res = {}

    # K2 taumol, with the eta bins both versions used
    bins_k = torch.empty((16, NBIN, L_MAIN, B_MAIN), dtype=torch.int32,
                         device=device)
    tg_k, fr_k = taumol_blocked(sc, prof, model.engine, model.kernel_tabs,
                                model.kernel_desc, bins=bins_k)
    tg_p, fr_p = model.engine.blocked(sc, prof)
    bins_p = model.engine.bins(sc, prof)
    nbad = int((bins_k != bins_p).sum())
    need(nbad == 0, f"taumol: {nbad} interpolation bins differ")
    e_t = float(((tg_k.double() - tg_p.double()).abs()
                 / tg_p.double().abs().clamp(min=1e-2)).max())
    e_f = float((fr_k - fr_p).abs().max())
    need(torch.isfinite(tg_k).all() and torch.isfinite(fr_k).all(),
         "taumol: non-finite output")
    need(e_t <= TOL_TAUMOL and e_f <= TOL_TAUMOL,
         f"taumol: taug rel {e_t:.3g}, fracs abs {e_f:.3g} > {TOL_TAUMOL}")
    res["taumol"] = dict(
        max_abs_err=max(float((tg_k - tg_p).abs().max()), e_f),
        max_rel_err=e_t,
        ms=cuda_ms(lambda: taumol_blocked(sc, prof, model.engine,
                                          model.kernel_tabs,
                                          model.kernel_desc), 5),
        plain_ms=cuda_ms(lambda: model.engine.blocked(sc, prof), 2))
    print(f"taumol: taug rel {e_t:.3g}, fracs abs {e_f:.3g}, bins equal "
          f"({bins_k.numel()} cells x bands x slots)")

    # K3 Planck, at layer and level temperatures
    tlay, tlev = prof.tavel.t().contiguous(), prof.tz.t().contiguous()
    tot = model.totplnk
    outs = [(planck_interp_blocked(t, tot), interp_planck_blocked(t, tot))
            for t in (tlay, tlev)]
    e = max(float((k - p).abs().max() / p.abs().max()) for k, p in outs)
    need(e <= TOL_TABLE, f"planck: rel err {e:.3g} > {TOL_TABLE}")
    res["planck"] = dict(
        max_abs_err=max(float((k - p).abs().max()) for k, p in outs),
        max_rel_err=e,
        ms=cuda_ms(lambda: (planck_interp_blocked(tlay, tot),
                            planck_interp_blocked(tlev, tot)), 20),
        plain_ms=cuda_ms(lambda: (interp_planck_blocked(tlay, tot),
                                  interp_planck_blocked(tlev, tot)), 20))
    planklay_t, planklev_t = outs[0][0], outs[1][0]

    # K4 cloud coefficients
    reic, relq = clouds.reicmc, clouds.relqmc
    kk = ice_liq_coeffs_blocked(reic, relq, 3, 1, static)
    pp = cldprop.ice_liq_coeffs_blocked(reic, relq, 3, 1, static)
    e = max(float((k - p).abs().max() / p.abs().max())
            for k, p in zip(kk, pp))
    need(e <= TOL_TABLE, f"cldcoef: rel err {e:.3g} > {TOL_TABLE}")
    res["cldcoef"] = dict(
        max_abs_err=max(float((k - p).abs().max()) for k, p in zip(kk, pp)),
        max_rel_err=e,
        ms=cuda_ms(lambda: ice_liq_coeffs_blocked(reic, relq, 3, 1,
                                                  static), 20),
        plain_ms=cuda_ms(lambda: cldprop.ice_liq_coeffs_blocked(
            reic, relq, 3, 1, static), 20))

    # K1 RT sweep, clear and compact McICA, on the kernels' outputs
    taut = tg_k + prof.taua.permute(1, 2, 0)[:, model.ngb0.long(), :]
    cw_t = torch.stack([clouds.ciwp.t(), clouds.clwp.t()], 1).contiguous()
    fields = (clouds.cldfmc, cw_t, kk[0], kk[1])
    args = (taut, fr_k, planklay_t, planklev_t, sc.plankbnd, prof.semiss,
            prof.pwvcm, model.ngb0, model.wg)
    errs, absd = [], []
    for cf in (None, fields):
        fk = rt_fluxes_blocked(*args, cloud_fields=cf)
        fp = rtrn.rt_fluxes_blocked(*args, cloud_fields=cf)
        need(torch.isfinite(fk).all(), "rt_sweep: non-finite fluxes")
        errs.append(flux_err(fp, fk))
        absd.append(float((fk - fp).abs().max()))
    need(max(errs) <= TOL_FLUX,
         f"rt_sweep: flux err clear {errs[0]:.3g} cloudy {errs[1]:.3g}")
    res["rt_sweep"] = dict(
        max_abs_err=max(absd), max_rel_err=max(errs),
        ms=cuda_ms(lambda: rt_fluxes_blocked(*args, cloud_fields=fields),
                   5),
        plain_ms=cuda_ms(lambda: rtrn.rt_fluxes_blocked(
            *args, cloud_fields=fields), 2))
    print(f"rt_sweep: flux err clear {errs[0]:.3g}, cloudy {errs[1]:.3g}")
    for name, r in res.items():
        print(f"{name}: max_abs_err {r['max_abs_err']:.3g} "
              f"max_rel_err {r['max_rel_err']:.3g} kernel {r['ms']:.3f} ms "
              f"plain {r['plain_ms']:.3f} ms")
    return res


def run_steps(model, atm, clouds, steps):
    """Fluxes of the last of ``steps`` calls and host ms per step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fl = model(atm, clouds)
    torch.cuda.synchronize()
    return fl, (time.perf_counter() - t0) * 1e3 / steps


def compare_models(tag, fk, fe, cloudy):
    """The kernels' Fluxes against the eager model's on the card."""
    B, L1 = fk.uflx.shape
    for name in ("uflx", "dflx", "uflxc", "dflxc", "hr", "hrc"):
        x = getattr(fk, name)
        need(x.shape[0] == B and torch.isfinite(x).all(),
             f"{tag}: {name} not finite or mis-shaped {tuple(x.shape)}")
    err = max(flux_err(getattr(fe, n).t(), getattr(fk, n).t())
              for n in ("uflx", "dflx", "uflxc", "dflxc"))
    need(err <= TOL_FLUX, f"{tag}: flux err vs eager {err:.3g}")
    olr = fk.uflx[:, -1]
    need(bool(((olr > 100) & (olr < 400)).all()),
         f"{tag}: outgoing LW outside 100-400 W/m2")
    if cloudy:
        need(fk.cld_bounds_ok is not None
             and torch.equal(fk.cld_bounds_ok, fe.cld_bounds_ok),
             f"{tag}: cld_bounds_ok differs")
    return err


def phase_end_to_end(device, counters):
    from rrtmg_lw_torch import LWConfig, make_model
    cfg = dict(dtype="float32", use_lut=False)
    atm, clouds = inputs(L_MAIN, device)
    models = {(icld, impl): make_model(
        LWConfig(icld=icld, imca=1, impl=impl, **cfg), device=device)
        for icld in (0, 2) for impl in ("cuda", "eager")}
    # warm up outside the counted run (first launches, allocator)
    for icld in (0, 2):
        models[icld, "cuda"](atm, clouds if icld else None)
    torch.cuda.synchronize()

    for fn in counters.values():
        fn.launches = 0
    runs = {}
    for icld in (0, 2):
        cl = clouds if icld else None
        runs[icld, "cuda"] = run_steps(models[icld, "cuda"], atm, cl, STEPS)
        if icld == 0:
            need(counters["cldcoef"].launches == 0,
                 "cldcoef launched on the clear run")
    launches = {k: fn.launches for k, fn in counters.items()}
    need(all(n > 0 for n in launches.values()),
         f"a kernel of the main path never launched: {launches}")
    print(f"launches in the main-path run: {launches}")

    rows = []
    for icld in (0, 2):
        cl = clouds if icld else None
        runs[icld, "eager"] = run_steps(models[icld, "eager"], atm, cl, 1)
        tag = "clear" if icld == 0 else "mcica_cloudy"
        err = compare_models(tag, runs[icld, "cuda"][0],
                             runs[icld, "eager"][0], icld)
        for impl in ("cuda", "eager"):
            ms = runs[icld, impl][1]
            rows.append(dict(cell=tag, impl=impl, ncol=B_MAIN, nlay=L_MAIN,
                             ms_per_step=ms,
                             cols_per_sec=B_MAIN / (ms * 1e-3)))
        print(f"{tag}: flux err cuda vs eager {err:.3g}")
    return launches, rows


def phase_deep(device, counters):
    from rrtmg_lw_torch import LWConfig, make_model
    atm, clouds = inputs(L_DEEP, device)
    out = {}
    for impl in ("cuda", "eager"):
        m = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False, impl=impl), device=device)
        if impl == "cuda":
            m(atm, clouds)                       # warm-up
            before = {k: fn.launches for k, fn in counters.items()}
        out[impl] = run_steps(m, atm, clouds, 1)
        if impl == "cuda":
            need(all(fn.launches > before[k] for k, fn in counters.items()),
                 "mcica_cloudy_deep: a kernel of the path never launched")
        del m
    err = compare_models("mcica_cloudy_deep", out["cuda"][0],
                         out["eager"][0], True)
    print(f"mcica_cloudy_deep: flux err cuda vs eager {err:.3g}")
    return [dict(cell="mcica_cloudy_deep", impl=impl, ncol=B_MAIN,
                 nlay=L_DEEP, ms_per_step=out[impl][1],
                 cols_per_sec=B_MAIN / (out[impl][1] * 1e-3))
            for impl in ("cuda", "eager")]


def main() -> int:
    # importing the port first: from a directory without it this fails
    # before anything is printed
    from rrtmg_lw_torch import _build
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_blocked
    from rrtmg_lw_torch.ops.planck_cuda import planck_interp_blocked
    from rrtmg_lw_torch.ops.rtrn_cuda import rt_fluxes_blocked
    from rrtmg_lw_torch.ops.taumol_cuda import taumol_blocked

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = nvidia_smi_line()
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} visible")
    print(smi, flush=True)

    # 2. build
    path, secs = _build.build()
    _build.library()
    print(f"build: {path} in {secs:.1f} s", flush=True)
    for line in (path.parent / "build.log").read_text().splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())

    # 3. kernels vs plain versions
    res = phase_kernels(device)
    torch.cuda.empty_cache()

    # 4. end to end, with the launch counters
    counters = {"taumol": taumol_blocked, "planck": planck_interp_blocked,
                "cldcoef": ice_liq_coeffs_blocked,
                "rt_sweep": rt_fluxes_blocked}
    launches, rows = phase_end_to_end(device, counters)
    torch.cuda.empty_cache()

    # 5. deep
    rows += phase_deep(device, counters)
    for r in rows:
        print("e2e " + json.dumps(r))

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **res[name])
               for name, src, rep in KERNELS]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
