#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch/CUDA port (``rrtmg_lw_torch``).

Run from the repository root on a machine with one CUDA GPU (Hopper,
sm_90a):

    python3 chip_smoke.py

Phases, each raising on failure (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the seven CUDA kernels from csrc/ (one nvcc per source, in
     parallel), timed;
  3. each kernel against its plain PyTorch version on the card at the
     main-path shapes (B=16384 columns, L=60 layers, float32), with the
     max error and CUDA-event times of both;
  4. end to end: clear sky and McICA (compact int8-mask clouds), 3 steps
     each through the kernels, launch counters reset just before and
     read just after; fluxes held against the same model run with
     impl="eager" on the card;
  5. deep: one McICA step at L=140 with the same checks;
  6. grad: each backward kernel (K3b Planck slope, K5 taumol, K6 RT
     adjoint) against the plain vjp of its forward's plain version on the
     phase-3 tensors (B=16384, L=60), errors, bitwise repeat and times;
     then the gradient step (make_grad_step, the default loss, w.r.t.
     every Atmosphere field) at B=16384, L=60 through the kernels: McICA,
     3 timed steps with the launch counters reset just before and read
     just after, peak memory; its gradients of a column-sum loss, linear
     in the four flux arrays with seeded cotangents, held on all 16384
     columns against the eager step's (run in column chunks); clear sky,
     1 step, the same check.
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
B_CHUNK = 4096             # columns per eager grad step in the step check
# tolerances of the TPU port's on-chip gates (tools/tpu_verify.py:97,
# ROADMAP.md:17), kept
TOL_TABLE = 1e-6        # K3, K4: max |kernel - plain| / max |plain|
TOL_TAUMOL = 3.05e-5    # K2: taug relative (|ref| floored at 1e-2), fracs abs
TOL_FLUX = 2e-5         # K1 / model: per column, / max(max |flux|, 1)
# backward kernels against their plain vjps: the same f32 math summed in
# another order, / max |plain| per output (K6: a recurrence over levels)
TOL_BWD, TOL_BWD_RT = 1e-4, 1e-3
# the grad step against the eager one, per Atmosphere field / max |eager|,
# for a loss linear in the fluxes: f32 against f64 on the CPU reads
# <= 1.1e-5 (tests/test_torch_grad.py::test_f32_gradient_conditioning)
TOL_STEP = 1e-4

KERNELS = (  # name, source, replaced TPU kernel
    ("taumol", "rrtmg_lw_torch/csrc/taumol.cu",
     "rrtmg_lw_tpu/ops/taumol_pallas.py:1068"),
    ("planck", "rrtmg_lw_torch/csrc/planck.cu",
     "rrtmg_lw_tpu/ops/planck_pallas.py:47"),
    ("cldcoef", "rrtmg_lw_torch/csrc/cldcoef.cu",
     "rrtmg_lw_tpu/ops/cldcoef_pallas.py:43"),
    ("rt_sweep", "rrtmg_lw_torch/csrc/rtrn.cu",
     "rrtmg_lw_tpu/ops/rtrn_pallas.py:140"),
    ("taumol_bwd", "rrtmg_lw_torch/csrc/taumol_bwd.cu",
     "rrtmg_lw_tpu/ops/taumol_pallas.py:1116"),
    ("planck_bwd", "rrtmg_lw_torch/csrc/planck.cu",
     "rrtmg_lw_tpu/ops/planck_pallas.py:137"),
    ("rt_adjoint", "rrtmg_lw_torch/csrc/rtrn_bwd.cu",
     "rrtmg_lw_tpu/ops/rtrn_bwd.py:259"),
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


def rel_err(got, ref):
    """max |got - ref| / max |ref| (the absolute error where ref is 0)."""
    scale = float(ref.double().abs().max())
    diff = float((got.double() - ref.double()).abs().max())
    return diff / scale if scale > 0 else diff


def columns(atm, clouds, cols):
    """The columns ``cols`` (a slice) of an Atmosphere and compact clouds
    (or None)."""
    from rrtmg_lw_torch import Atmosphere, McicaCloudsCompact
    atm = Atmosphere(*(x[cols] for x in atm))
    if clouds is None:
        return atm, None
    return atm, McicaCloudsCompact(clouds.cldfmc[..., cols].contiguous(),
                                   *(x[cols] for x in clouds[1:]))


def phase_grad_kernels(device):
    """Each backward kernel vs the plain vjp on the phase-3 tensors; two
    runs of each kernel must be bitwise equal."""
    from rrtmg_lw_torch import LWConfig, make_model
    from rrtmg_lw_torch.ops import rtrn
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_blocked
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.ops.planck_cuda import planck_interp_vjp
    from rrtmg_lw_torch.ops.rtrn_cuda import rt_sweep_vjp
    from rrtmg_lw_torch.ops.setcoef import (interp_planck_blocked,
                                            interp_planck_vjp, setcoef)
    from rrtmg_lw_torch.ops.taumol_cuda import (_pack_inputs,
                                                taumol_packed,
                                                taumol_packed_vjp,
                                                taumol_vjp)

    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False, impl="cuda"), device=device)
    atm, clouds = inputs(L_MAIN, device)
    prof = inatm(atm, dtype=torch.float32)
    static = model.static_tensors()
    gen = torch.Generator(device=device).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def check(name, got, ref, tol, again):
        errs, absd = [], []
        for g, r in zip(got, ref):
            if r is None:
                continue
            need(g is not None and g.shape == r.shape
                 and bool(torch.isfinite(g).all()),
                 f"{name}: non-finite or mis-shaped output")
            errs.append(rel_err(g, r))
            absd.append(float((g - r).abs().max()))
        need(max(errs) <= tol, f"{name}: rel err {max(errs):.3g} > {tol} "
             f"(per output: {[f'{e:.2g}' for e in errs]})")
        need(all(a is None or torch.equal(g, a) for g, a in zip(got, again)),
             f"{name}: two runs differ")
        return dict(max_abs_err=max(absd), max_rel_err=max(errs))

    res = {}
    # K3b at layer and level temperatures
    temps = (prof.tavel.t().contiguous(), prof.tz.t().contiguous())
    cts = [randn(t.shape[0], 16, B_MAIN) for t in temps]
    tot = model.totplnk
    res["planck_bwd"] = check(
        "planck_bwd",
        [planck_interp_vjp(t, tot, c) for t, c in zip(temps, cts)],
        [interp_planck_vjp(t, tot, c) for t, c in zip(temps, cts)], TOL_BWD,
        [planck_interp_vjp(t, tot, c) for t, c in zip(temps, cts)])
    res["planck_bwd"].update(
        ms=cuda_ms(lambda: [planck_interp_vjp(t, tot, c)
                            for t, c in zip(temps, cts)], 20),
        plain_ms=cuda_ms(lambda: [interp_planck_vjp(t, tot, c)
                                  for t, c in zip(temps, cts)], 5))

    # K5 per field, on the main-path cells and on boosted ones that cross
    # the minor-gas over-abundance thresholds
    sc = setcoef(prof, static, planck=False)
    fld, ifld = _pack_inputs(sc, prof)
    ct_t, ct_f = randn(L_MAIN, 140, B_MAIN), randn(L_MAIN, 140, B_MAIN)
    eng, tabs, desc = model.engine, model.kernel_tabs, model.kernel_desc
    out, ref, again = [], [], []
    for boost in (None, (1.0, 8.0, 1.0, 50.0, 1.0, 20.0, 1.0)):
        p = prof if boost is None else prof._replace(
            wkl=prof.wkl * torch.tensor(boost, device=device))
        f, i = _pack_inputs(setcoef(p, static, planck=False), p)
        out += list(taumol_vjp(f, i, eng, tabs, desc, ct_t, ct_f))
        ref += list(taumol_packed_vjp(eng, f, i, ct_t, ct_f))
        again += list(taumol_vjp(f, i, eng, tabs, desc, ct_t, ct_f))
    res["taumol_bwd"] = check("taumol_bwd", out, ref, TOL_BWD, again)
    res["taumol_bwd"].update(
        ms=cuda_ms(lambda: taumol_vjp(fld, ifld, eng, tabs, desc, ct_t,
                                      ct_f), 5),
        plain_ms=cuda_ms(lambda: taumol_packed_vjp(eng, fld, ifld, ct_t,
                                                   ct_f), 2))

    # K6, clear and compact McICA, on the forward's own tensors
    taug, fracs = taumol_packed(eng, fld, ifld)
    taut = taug + prof.taua.permute(1, 2, 0)[:, model.ngb0.long(), :]
    play, plev = (interp_planck_blocked(t, tot) for t in temps)
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm,
                          torch.float32)
    abi, abl = ice_liq_coeffs_blocked(clouds.reicmc, clouds.relqmc, 3, 1,
                                      static)
    cw = torch.stack([clouds.ciwp.t(), clouds.clwp.t()], 1).contiguous()
    ct = randn(4, L_MAIN + 1, B_MAIN)
    out, ref, again = [], [], []
    for cf in ((None,) * 4, (cw, abi, abl, clouds.cldfmc)):
        args = (taut, fracs, play, plev, surf, *cf, model.ngb0, model.wg,
                ct)
        out += list(rt_sweep_vjp(*args))
        ref += list(rtrn.rt_sweep_vjp(*args))
        again += list(rt_sweep_vjp(*args))
    res["rt_adjoint"] = check("rt_adjoint", out, ref, TOL_BWD_RT, again)
    res["rt_adjoint"].update(
        ms=cuda_ms(lambda: rt_sweep_vjp(*args), 5),
        plain_ms=cuda_ms(lambda: rtrn.rt_sweep_vjp(*args), 1))
    for name, r in res.items():
        print(f"{name}: max_abs_err {r['max_abs_err']:.3g} "
              f"max_rel_err {r['max_rel_err']:.3g} kernel {r['ms']:.3f} ms "
              f"plain {r['plain_ms']:.3f} ms")
    return res


def grad_errs(tag, gk, ge):
    """Per Atmosphere field, max |kernels - eager| / max |eager|; printed."""
    errs = {}
    for name in gk._fields:
        g, r = getattr(gk, name), getattr(ge, name)
        need(g.shape == r.shape and bool(torch.isfinite(g).all()),
             f"{tag}: gradient of {name} not finite or mis-shaped")
        errs[name] = rel_err(g, r)
    worst = max(errs, key=errs.get)
    print(f"{tag}: gradients on {B_MAIN} columns, kernels vs eager, max rel "
          f"err {errs[worst]:.3g} ({worst}); " + ", ".join(
              f"{k} {v:.2g}" for k, v in errs.items()))
    return worst, errs[worst]


def phase_grad_step(device, counters):
    from rrtmg_lw_torch import LWConfig, make_model
    from rrtmg_lw_torch.parallel import make_grad_step
    cfg = dict(dtype="float32", use_lut=False)
    atm, clouds = inputs(L_MAIN, device)
    # The gate's loss sums seeded cotangents times uflx, dflx, uflxc and
    # dflxc over every level and column.  Linear in the fluxes, its
    # gradient reads the forward only through the kernels' linearization
    # points, so the two backward paths are held to each other.  The
    # default loss is not: its hr**2 term is ill-conditioned in f32 at the
    # top layers (tests/test_torch_grad.py::test_f32_gradient_conditioning).
    gen = torch.Generator(device=device).manual_seed(7)
    cts = [torch.randn(B_MAIN, L_MAIN + 1, generator=gen, device=device)
           for _ in range(4)]

    def linear(cts):
        return lambda f: sum((c * x).sum() for c, x in zip(
            cts, (f.uflx, f.dflx, f.uflxc, f.dflxc)))

    rows, launches = [], None
    for icld, steps in ((2, STEPS), (0, 1)):
        tag = "mcica_cloudy_grad" if icld else "clear_grad"
        cl = clouds if icld else None
        model = make_model(LWConfig(icld=icld, imca=1, impl="cuda", **cfg),
                           device=device)
        step = make_grad_step(model)
        step(atm, cl)                               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, grads = step(atm, cl)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        counts = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        need(bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads),
             f"{tag}: non-finite loss or gradient")
        need(all(n > 0 for k, n in counts.items()
                 if icld or k != "cldcoef"),
             f"{tag}: a kernel of the path never launched: {counts}")
        if icld:
            launches = counts
        else:
            need(counts["cldcoef"] == 0, "cldcoef launched on clear_grad")
        print(f"{tag}: launches in the timed steps: {counts}")
        del step, grads
        # the gate, on every column; the loss is a sum over columns, so
        # the eager step runs in column chunks
        _, gk = make_grad_step(model, linear(cts))(atm, cl)
        eager = make_model(LWConfig(icld=icld, imca=1, impl="eager", **cfg),
                           device=device)
        chunks = [make_grad_step(eager, linear([c[s] for c in cts]))(
            *columns(atm, cl, s))[1] for s in (
                slice(i, i + B_CHUNK) for i in range(0, B_MAIN, B_CHUNK))]
        ge = type(gk)(*(torch.cat(g) for g in zip(*chunks)))
        worst, err = grad_errs(tag, gk, ge)
        need(err <= TOL_STEP,
             f"{tag}: gradient of {worst} off by {err:.3g} of max |eager|")
        rows.append(dict(cell=tag, impl="cuda", ncol=B_MAIN, nlay=L_MAIN,
                         ms_per_step=ms, cols_per_sec=B_MAIN / (ms * 1e-3),
                         peak_gib=peak, grad_rel_err_vs_eager=err))
        del model, eager, gk, ge, chunks
        torch.cuda.empty_cache()
    return launches, rows


def main() -> int:
    # importing the port first: from a directory without it this fails
    # before anything is printed
    from rrtmg_lw_torch import _build
    from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_blocked
    from rrtmg_lw_torch.ops.planck_cuda import (planck_interp_blocked,
                                                planck_interp_vjp)
    from rrtmg_lw_torch.ops.rtrn_cuda import rt_fluxes_blocked, rt_sweep_vjp
    from rrtmg_lw_torch.ops.taumol_cuda import taumol_blocked, taumol_vjp

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
    torch.cuda.empty_cache()

    # 6. grad: backward kernels vs plain vjps, then the gradient step
    res.update(phase_grad_kernels(device))
    torch.cuda.empty_cache()
    counters.update(taumol_bwd=taumol_vjp, planck_bwd=planck_interp_vjp,
                    rt_adjoint=rt_sweep_vjp)
    grad_launches, grad_rows = phase_grad_step(device, counters)
    rows += grad_rows
    launches.update({k: grad_launches[k]
                     for k in ("taumol_bwd", "planck_bwd", "rt_adjoint")})
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
