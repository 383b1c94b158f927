"""One-shot on-card verification of the port's kernels.

The counterpart of the JAX package's ``tools/tpu_verify.py:50-325``: the
CPU tests hold the kernels' plain versions to JAX; this tool runs the
hand-written kernels (``impl="cuda"``) against the plain PyTorch path
(``impl="eager"``) on the same card, in float32, and writes a JSON
pass/fail table with each check's max error.  Every check keeps the JAX
tool's name and tolerance:

  kernel level: taumol (K2) against the plain engine; the Planck kernel
  (K3) against setcoef's planklay; model level: clear, McICA (batch
  per-g arrays, compact with a float mask, idrv=1), banded icld=1,
  maximum-random icld=2, each whole step through the kernels against the
  eager step on identical inputs; the isothermal enclosure through the
  kernels against the first-principles blackbody quadrature
  (``utils.blackbody``); the wire format decoded on the card (K9) and
  sampled there (K8) against the direct inputs under the same Philox
  key; the deep profile (L=140); and the production shapes at B=16384
  (compact int8 mask, maximum-random), the eager step in 2048-column
  chunks.

The taumol and Planck checks use 4 x 2^-17, the JAX tool's split
precision bound: the same number as ``chip_smoke.py``'s ``TOL_TAUMOL``
(3.05e-5); the flux checks 2e-5 of max(max |flux|, 1); the wire checks
absolute W/m2.

    python -m rrtmg_lw_torch.tools.gpu_verify [--batch 512] [--out PATH]
        [--device cpu]

It runs on the card unless ``--device cpu`` is given (and raises where
there is none).  ``--device cpu`` runs the harness with
``model.impl = "cuda"`` on a CPU model, which drives the kernel
wrappers' plain versions, against ``impl="eager"``, and skips the two
B=16384 checks.  The JSON goes to ``--out`` (default ``GPU_VERIFY.json``
in the temporary directory).  Exit code 1 on any failing check.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import tempfile
import time

import numpy as np
import torch

SPLIT_TOL = 2.0 ** -17          # the JAX tool's split precision
FLUX_TOL = 2e-5                 # of max(max |flux|, 1); ~10x the split bound
FLUX_NAMES = ("uflx", "dflx", "uflxc", "dflxc")
T_ISO = 288.6                   # K, the isothermal enclosure
B_PROD, CHUNK = 16384, 2048     # the production shape; eager columns a call
# each check's tolerance (tools/tpu_verify.py's)
TOLS = {
    "taumol_kernel_taug_rel": 4 * SPLIT_TOL,
    "taumol_kernel_fracs_abs": 4 * SPLIT_TOL,
    "planck_blocked_rel": 4 * SPLIT_TOL,
    "model_clear": FLUX_TOL,
    "model_mcica_plain": FLUX_TOL,
    "model_mcica_compact": FLUX_TOL,
    "model_mcica_idrv": FLUX_TOL,
    "model_banded_icld1": FLUX_TOL,
    "model_maxrand_icld2": FLUX_TOL,
    "invariant_isothermal_sfc_vs_blackbody": 3e-4,
    "invariant_isothermal_level_envelope": 5e-4,
    "model_wire_input_noise_abs_wm2": 1e-2,
    "model_wire_full_clear_abs_wm2": 1e-2,
    "model_wire_full_mean_abs_wm2": 5e-3,
    "model_mcica_deep_nlay140": FLUX_TOL,
    "model_mcica_compact_i8_B16k": FLUX_TOL,
    "model_maxrand_icld2_B16k": FLUX_TOL,
}
MCICA = dict(icld=2, imca=1, inflag=2, iceflag=3, liqflag=1)
MAXRAND = dict(icld=2, imca=0, inflag=2, iceflag=3, liqflag=1)


def nvidia_smi() -> str:
    """The card's name and power limit (``nvidia-smi``)."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def flux_err(a, b):
    """Max abs difference over the four flux fields of two Fluxes, each
    scaled by max(max |a|, 1)."""
    err = 0.0
    for n in FLUX_NAMES:
        x, y = getattr(a, n).double(), getattr(b, n).double()
        err = max(err, float((x - y).abs().max())
                  / max(float(x.abs().max()), 1.0))
    return err


def abs_wm2(a, b, names):
    return max(float((getattr(a, n).double() - getattr(b, n).double())
                     .abs().max()) for n in names)


class Checks:
    """The results, in order: each ``record`` adds one row and prints it."""

    def __init__(self):
        self.rows = []

    def record(self, name, max_err, extra=None):
        tol = TOLS[name]
        ok = bool(max_err <= tol)
        self.rows.append(dict(check=name, max_err=float(max_err),
                              tol=float(tol), ok=ok, **(extra or {})))
        print(f"{'PASS' if ok else 'FAIL'}  {name:42s} "
              f"max_err={max_err:.3e}  tol={tol:.1e}", flush=True)
        return ok


def column_chunk(tree, cols):
    """The columns ``cols`` (a slice) of an input tree, each leaf cut in
    its layout (``parallel.mesh.map_batch``), contiguous."""
    from ..parallel.mesh import map_batch

    def leaf(x, _, axis):
        if x is None or axis is None:
            return x
        idx = [slice(None)] * x.dim()
        idx[axis] = cols
        return x[tuple(idx)].contiguous()
    return map_batch(tree, None, leaf)


def verify(device, batch=512) -> dict:
    """Run every check on ``device`` (the JAX tool's layout: backend,
    device, batch, elapsed_s, the tolerances, all_ok, checks).  On a CPU
    device the "kernel" models are CPU models with ``impl = "cuda"`` (the
    wrappers' plain versions), and the B=16384 checks are skipped."""
    from .. import (Atmosphere, BandClouds, LWConfig, McicaClouds,
                    McicaCloudsCompact, make_model)
    from ..data.ktables import load_tables
    from ..ops import mcica
    from ..ops.inatm import inatm
    from ..ops.planck_cuda import planck_interp_blocked
    from ..ops.setcoef import setcoef
    from ..ops.taumol_cuda import taumol_blocked
    from ..parallel import wire as w
    from ..utils.blackbody import band_anchor
    from ..utils.synthetic import (make_atmosphere, make_band_clouds,
                                   make_cloud_profile_fields,
                                   make_mcica_clouds)

    device = torch.device(device)
    cpu = device.type == "cpu"
    f32 = torch.float32
    tables = load_tables(device, f32)
    checks = Checks()
    t0 = time.time()

    def models(**kw):
        """(eager, kernels) models of one float32 config on ``device``."""
        cfg = LWConfig(dtype="float32", use_lut=False, **kw)
        eager = make_model(cfg.replace(impl="eager"), device, tables)
        kern = make_model(cfg.replace(impl="eager" if cpu else "cuda"),
                          device, tables)
        if cpu:
            kern.impl = "cuda"
        return eager, kern

    def inputs(B, L):
        return Atmosphere.from_numpy(make_atmosphere(B, L, dtype=np.float32),
                                     device, f32)

    # ---- kernel level: taumol, Planck ---------------------------------
    B = batch
    atm = inputs(B, 60)
    eager0, kern0 = models(icld=0)
    prof = inatm(atm, f32)
    sc = setcoef(prof, eager0.static_tensors())
    tg_e, fr_e = eager0.engine.blocked(sc, prof)
    tg_k, fr_k = taumol_blocked(sc, prof, kern0.engine, kern0.kernel_tabs,
                                kern0.kernel_desc)
    tg_e, fr_e, tg_k, fr_k = (x.double() for x in (tg_e, fr_e, tg_k, fr_k))
    # relative od error with the denominator floored at od = 0.01: below
    # it the absolute error bounds the transmission's (1 - exp(-od) ~ od)
    checks.record("taumol_kernel_taug_rel", float(
        ((tg_k - tg_e).abs() / tg_e.abs().clamp(min=1e-2)).max()))
    checks.record("taumol_kernel_fracs_abs",
                  float((fr_k - fr_e).abs().max()))
    # setcoef's planklay is (B, L, 16), the kernel's (L, 16, B)
    pl = planck_interp_blocked(prof.tavel.t().contiguous(), kern0.totplnk)
    ref = sc.planklay.permute(1, 2, 0).double()
    checks.record("planck_blocked_rel", float(
        (pl.double() - ref).abs().max()) / max(float(ref.abs().max()),
                                               1e-12))
    del tg_e, fr_e, tg_k, fr_k, pl, ref

    # ---- model level ----------------------------------------------------
    def check_model(name, kw, atm_l, clouds, extra=None):
        eager, kern = models(**kw)
        checks.record(name, flux_err(eager(atm_l, clouds),
                                     kern(atm_l, clouds)), extra)

    check_model("model_clear", dict(icld=0), atm, None)
    mc = McicaClouds.from_numpy(make_mcica_clouds(
        B, 60, dtype=np.float32, layout="batch"), device, f32)
    check_model("model_mcica_plain", MCICA, atm, mc)
    mcc = McicaCloudsCompact.from_numpy(make_mcica_clouds(
        B, 60, dtype=np.float32, layout="compact"), device, f32)
    check_model("model_mcica_compact", MCICA, atm, mcc)
    check_model("model_mcica_idrv", dict(MCICA, idrv=1), atm, mc)
    bc = BandClouds.from_numpy(make_band_clouds(B, 60, dtype=np.float32),
                               device, f32)
    check_model("model_banded_icld1", dict(MAXRAND, icld=1), atm, bc)
    check_model("model_maxrand_icld2", MAXRAND, atm, bc)
    del mc, mcc, bc

    # ---- the isothermal enclosure through the kernels, against the
    # blackbody quadrature (no k-tables, no plain path)
    atm_iso = atm._replace(
        tlay=torch.full_like(atm.tlay, T_ISO),
        tlev=torch.full_like(atm.tlev, T_ISO),
        tsfc=torch.full_like(atm.tsfc, T_ISO),
        emis=torch.ones_like(atm.emis))
    anchor = band_anchor(kern0.static_np, T_ISO)
    u = kern0(atm_iso).uflx.double()
    checks.record("invariant_isothermal_sfc_vs_blackbody",
                  float((u[:, 0] / anchor - 1).abs().max()),
                  dict(anchor_wm2=round(float(anchor), 4)))
    checks.record("invariant_isothermal_level_envelope",
                  float((u / anchor - 1).abs().max()))

    # ---- the wire format: decoded on the device (K9), sampled there (K8)
    # under the same key as the direct inputs; the quantization budget
    cpf = make_cloud_profile_fields(B, 60)
    cp = {k: torch.as_tensor(v, device=device) for k, v in cpf.items()}
    wkey = mcica.key(11)
    _, wire_model = models(**MCICA)

    def wgen(cldfrac, c):
        return mcica.mcica_subcol_lw_compact(
            wkey, 2, cldfrac, c["ciwp"], c["clwp"], c["rei"], c["rel"],
            mask_dtype=torch.int8)

    f_dir = wire_model(atm, wgen(cp["cldfrac"], cp))
    atm_np = make_atmosphere(B, 60, dtype=np.float32)
    a2 = w.decode_atmosphere(w.encode_atmosphere(atm_np), atm.tauaer)
    c2 = w.decode_cloud_profiles(w.encode_cloud_profiles(cpf), like=a2.play)
    f_full = wire_model(a2, wgen(c2["cldfrac"], c2))
    f_same = wire_model(a2, wgen(cp["cldfrac"], c2))
    flips = float((wgen(c2["cldfrac"], c2).cldfmc
                   != wgen(cp["cldfrac"], c2).cldfmc).float().mean())
    # the continuous inputs' quantization under the same mask: the input
    # noise budget
    checks.record("model_wire_input_noise_abs_wm2",
                  abs_wm2(f_same, f_dir, FLUX_NAMES),
                  dict(units="W/m2 absolute"))
    # the whole wire: quantized cloud fractions flip a few sub-column bits
    # (a statistically equivalent sample), so the clear-sky fluxes are
    # held absolutely and the all-sky ones in the batch mean
    checks.record("model_wire_full_clear_abs_wm2",
                  abs_wm2(f_full, f_dir, ("uflxc", "dflxc")),
                  dict(units="W/m2 absolute"))
    mean_err = max(float((getattr(f_full, n).double().mean(0)
                          - getattr(f_dir, n).double().mean(0)).abs().max())
                   for n in ("uflx", "dflx"))
    checks.record("model_wire_full_mean_abs_wm2", mean_err,
                  dict(units="W/m2 absolute batch-mean",
                       mask_flip_fraction=flips))
    del f_dir, f_full, f_same, a2, c2, cp

    # ---- the deep profile -----------------------------------------------
    mc140 = McicaClouds.from_numpy(make_mcica_clouds(
        256, 140, dtype=np.float32, layout="batch"), device, f32)
    check_model("model_mcica_deep_nlay140", MCICA, inputs(256, 140), mc140)
    del mc140

    # ---- the production shapes: the kernels at B=16384 against the eager
    # step in column chunks (its plain sweep holds the per-level state of
    # every column)
    def check_chunked(name, kw, atm_f, clouds_f):
        try:
            eager, kern = models(**kw)
            fk = kern(atm_f, clouds_f)
            parts = [eager(*column_chunk((atm_f, clouds_f),
                                         slice(i, i + CHUNK)))
                     for i in range(0, B_PROD, CHUNK)]
            fe = type(fk)(*(None if x is None else torch.cat(
                [getattr(p, n) for p in parts]) for n, x in
                zip(fk._fields, fk)))
            checks.record(name, flux_err(fe, fk), dict(batch=B_PROD))
        except Exception as e:          # the check fails, and says why
            checks.rows.append(dict(check=name, max_err=float("nan"),
                                    tol=TOLS[name], ok=False,
                                    error=f"{type(e).__name__}: {e}"[:300]))
            print(f"FAIL  {name:42s} {type(e).__name__}: {e}", flush=True)

    if not cpu:
        atm16 = inputs(B_PROD, 60)
        mcp = McicaCloudsCompact.from_numpy(make_mcica_clouds(
            B_PROD, 60, dtype=np.float32, mask_dtype=np.int8), device, f32)
        check_chunked("model_mcica_compact_i8_B16k", MCICA, atm16, mcp)
        del mcp
        bcp = BandClouds.from_numpy(make_band_clouds(
            B_PROD, 60, dtype=np.float32), device, f32)
        check_chunked("model_maxrand_icld2_B16k", MAXRAND, atm16, bcp)

    return dict(backend=device.type,
                device=("cpu" if cpu else torch.cuda.get_device_name(device)),
                nvidia_smi=None if cpu else nvidia_smi(), batch=batch,
                elapsed_s=round(time.time() - t0, 1), split_tol=SPLIT_TOL,
                flux_tol=FLUX_TOL,
                all_ok=all(r["ok"] for r in checks.rows), checks=checks.rows)


def main(argv=None) -> int:
    from ..config import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "GPU_VERIFY.json"))
    ap.add_argument("--device", default=None,
                    help="'cpu' for the harness on the CPU (the kernels' "
                         "plain versions); default the GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = verify(device, args.batch)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"\n{'ALL PASS' if out['all_ok'] else 'FAILURES'} -> {path} "
          f"({out['elapsed_s']}s)")
    return 0 if out["all_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
