"""Adjoint sensitivity analysis of longwave fluxes.

Port of ``examples/sensitivities.py:31-87``.  The reference's only
derivative is idrv=1: dF_up/dT_surface by a hand-coded linear recursion
(rrtmg_lw_rtrnmc.f90:495-527).  The port is differentiable end to end,
so ONE reverse pass gives the sensitivity profile of a scalar flux
functional to every input, batched over columns:

  dOLR/dT(layer)     the vertically resolved version of idrv; its surface
                     entry cross-checks against the reference-style
                     dF/dTsfc derivative output;
  dOLR/dln(q)(layer) the water-vapour sensitivity (W/m2 per log-vmr),
                     the radiative kernel GCM groups compute by finite
                     differences.

On the card (float32) the pass runs K2, K3 (layers and levels), K1
clear at idrv=1 keeping its radiances (K1 SAVE), K6 clear, K5 and K3b;
the loss reads no d/dT output, so K6's d/dT instantiation does not
launch.  ``--device cpu`` runs it in float64 on the plain versions.

    python -m rrtmg_lw_torch.examples.sensitivities [--ncol 512]
        [--nlay 60] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import Atmosphere, LWConfig, make_model
from ..config import resolve_device
from ..utils.synthetic import make_atmosphere

# clear sky, the idrv=1 derivative beside the adjoint, the closed-form
# optical-depth factors (the kernels' path on the card)
CONFIG = LWConfig(icld=0, idrv=1, use_lut=False)


def sensitivities(model, atm: Atmosphere) -> dict:
    """One reverse pass of the mean OLR, ``uflx[:, -1].mean()`` of
    ``model(atm)`` (an idrv=1 model), with respect to tlay, h2ovmr and
    tsfc.  -> {"olr": the mean OLR (W/m2), "kernel_T": dOLR/dT per layer
    per column (B, L) (W/m2/K), "kernel_q": dOLR/dln q (B, L) (W/m2),
    "d_tsfc": dOLR/dTsfc (B,), "duflx_dt_toa": the forward's idrv
    derivative at the top (B,)}; the gradients of the batch mean times B,
    so per column."""
    leaves = [x.detach().requires_grad_()
              for x in (atm.tlay, atm.h2ovmr, atm.tsfc)]
    fl = model(atm._replace(tlay=leaves[0], h2ovmr=leaves[1],
                            tsfc=leaves[2]))
    olr = fl.uflx[:, -1].mean()
    d_tlay, d_h2o, d_tsfc = torch.autograd.grad(olr, leaves)
    B = atm.tlay.shape[0]
    return {"olr": olr.detach(), "kernel_T": d_tlay * B,
            "kernel_q": d_h2o * leaves[1].detach() * B,
            "d_tsfc": d_tsfc * B,
            "duflx_dt_toa": fl.duflx_dt[:, -1].detach()}


def launch_counts() -> dict:
    """The launch counters of the kernels this pass may run (the CUDA
    wrappers'), by name."""
    from ..ops.planck_cuda import planck_interp_blocked, planck_interp_vjp
    from ..ops.rtrn_cuda import DDT_LAUNCHES, rt_fluxes_blocked, rt_sweep_vjp
    from ..ops.taumol_cuda import taumol_blocked, taumol_vjp
    return {"taumol": taumol_blocked, "planck": planck_interp_blocked,
            "rt_sweep": rt_fluxes_blocked,
            "rt_sweep_idrv": rt_fluxes_blocked.idrv,
            "rt_sweep_save": rt_fluxes_blocked.save,
            "rt_adjoint": rt_sweep_vjp, "taumol_bwd": taumol_vjp,
            "planck_bwd": planck_interp_vjp,
            "rt_adjoint_ddt_clear": DDT_LAUNCHES["clear"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncol", type=int, default=512)
    ap.add_argument("--nlay", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU (float64); default the GPU "
                         "(float32)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = "float32" if device.type == "cuda" else "float64"
    model = make_model(CONFIG.replace(dtype=dtype), device=device)
    atm = Atmosphere.from_numpy(
        make_atmosphere(args.ncol, args.nlay, dtype=np.dtype(dtype)), device,
        model.config.torch_dtype)
    counters = launch_counts()
    for c in counters.values():
        c.launches = 0
    s = sensitivities(model, atm)
    kernel_T, kernel_q, d_tsfc, ddt = (
        s[k].double().cpu().numpy()
        for k in ("kernel_T", "kernel_q", "d_tsfc", "duflx_dt_toa"))

    print(f"OLR mean: {float(s['olr']):.3f} W/m2 "
          f"({args.ncol} columns, {args.nlay} layers)")
    lay_T = int(np.argmax(kernel_T.mean(axis=0)))
    lay_q = int(np.argmin(kernel_q.mean(axis=0)))
    print(f"dOLR/dT    peaks at layer {lay_T}: "
          f"{kernel_T.mean(axis=0)[lay_T]:+.4f} W/m2/K (batch mean)")
    print(f"dOLR/dln q strongest at layer {lay_q}: "
          f"{kernel_q.mean(axis=0)[lay_q]:+.4f} W/m2 (greenhouse: <0)")
    # the surface-temperature adjoint against the reference-style idrv
    # derivative (duflx_dt at the top): idrv interpolates AER's tabulated
    # dB/dT (totplnkderiv), the adjoint differentiates the Planck
    # interpolation itself (the secant of the 1 K totplnk grid), so they
    # differ a little
    print(f"dOLR/dTsfc: adjoint {d_tsfc.mean():+.5f}  "
          f"idrv-path {ddt.mean():+.5f}  "
          f"(max |diff| {np.abs(d_tsfc - ddt).max():.2e})")
    if device.type == "cuda":
        print("launches:", {k: c.launches for k, c in counters.items()})
    return s


if __name__ == "__main__":
    main()
