"""Kernel outputs of one checkout, to hold two checkouts bitwise equal.

    PYTHONPATH=<checkout> python rrtmg_lw_torch/utils/snapshot.py --out A.pt
    python rrtmg_lw_torch/utils/snapshot.py --compare A.pt B.pt

``--out`` runs, on the card, K2 in float32 storage, K1 in all six
modes at idrv 0 and 1 and K6 in its clear and compact modes on the
inputs of ``chip_smoke.py``'s phase 3 (``utils/profiling.py``'s
``mcica_cloudy``, ``band_cloudy``, ``mcica_blocked`` and ``mcica_tauc``
cells at B=16384, L=60; K6 on seeded cotangents) and saves their
outputs.  Run it from each checkout (its own ``rrtmg_lw_torch`` first
on the path), then ``--compare`` prints, per output, whether the two
are bitwise equal, and exits non-zero unless all are.  The imports are
absolute, so ``PYTHONPATH`` picks the checkout whose kernels run; only
entry points that every checkout since the fourth slice (K1's fused and
cldf-odcld modes, idrv=1) has are used.
"""

from __future__ import annotations

import argparse
import sys

import torch


def k1_cloud_args(device, static, mc) -> dict:
    """Each K1 mode's cloud arguments on the clouds of
    ``utils/profiling.py``'s cells: {mode: (``rtrn_cuda.WRAPPERS`` key,
    cloud args)}.  clear: none; compact: ``mc``, the ``mcica_cloudy``
    cell's compact clouds; banded and maxrand: ``band_cloudy``'s; fused:
    ``mcica_blocked``'s; cldf-odcld: ``mcica_tauc``'s.  The plain cloud
    optics and overlap rows make the arguments.  ``chip_smoke.py`` uses
    it too; it stays here, where a run against an older checkout finds
    it."""
    from rrtmg_lw_torch.ops import cldprop, rtrnmr
    from rrtmg_lw_torch.utils.profiling import cell_inputs
    abi, abl = cldprop.ice_liq_coeffs_blocked(mc.reicmc, mc.relqmc, 3, 1,
                                              static)
    cw = torch.stack([mc.ciwp.t(), mc.clwp.t()], 1).contiguous()
    _, bc = cell_inputs("band_cloudy", device)
    taucb, _ = cldprop.cldprop_banded_blocked(bc, static, inflag=2,
                                              iceflag=3, liqflag=1)
    _, cb = cell_inputs("mcica_blocked", device)
    abi_b, abl_b = cldprop.ice_liq_coeffs_blocked(cb.reicmc, cb.relqmc, 3,
                                                  1, static)
    _, tc = cell_inputs("mcica_tauc", device)
    odc, cfc, _ = cldprop.cldprmc_blocked(tc, static, inflag=0, iceflag=3,
                                          liqflag=1)
    return {"clear": ("blocked", ()),
            "compact": ("blocked", ((mc.cldfmc, cw, abi, abl),)),
            "banded": ("banded", (bc.cldfrac.t().contiguous(), taucb)),
            "maxrand": ("maxrand", (rtrnmr.overlap_rows(bc.cldfrac),
                                    taucb)),
            "fused": ("fused", ((*cb[:4], abi_b, abl_b),)),
            "cldf_od": ("cldf_od", ((cfc, odc),))}


def outputs(device) -> dict:
    from rrtmg_lw_torch import LWConfig, make_model
    from rrtmg_lw_torch.ops import rtrn
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.ops.rtrn_cuda import WRAPPERS, rt_sweep_vjp
    from rrtmg_lw_torch.ops.setcoef import interp_planck_blocked, setcoef
    from rrtmg_lw_torch.ops.taumol_cuda import taumol_blocked
    from rrtmg_lw_torch.utils.profiling import cell_inputs
    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False), device=device)
    atm, mc = cell_inputs("mcica_cloudy", device)
    prof = inatm(atm, torch.float32)
    static = model.static_tensors()
    sc = setcoef(prof, static, planck=False)
    k2 = taumol_blocked(sc, prof, model.engine, model.kernel_tabs,
                        model.kernel_desc)
    tg, fr = model.engine.blocked(sc, prof)
    taut = tg + prof.taua.permute(1, 2, 0)[:, model.ngb0.long(), :]
    play, plev = (interp_planck_blocked(t.t().contiguous(), model.totplnk)
                  for t in (prof.tavel, prof.tz))
    args = (taut, fr, play, plev, sc.plankbnd, prof.semiss, prof.pwvcm,
            model.ngb0, model.wg)
    modes = k1_cloud_args(device, static, mc)
    out = {"k2_taug": k2[0], "k2_fracs": k2[1]}
    for name, (w, clouds) in modes.items():
        out[f"k1_{name}"] = WRAPPERS[w](*args, *clouds)
        out[f"k1_{name}_idrv"] = torch.cat(
            WRAPPERS[w](*args, *clouds, dplankbnd_dt=sc.dplankbnd_dt))
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm,
                          torch.float32)
    gen = torch.Generator(device=device).manual_seed(5)
    ct = torch.randn(out["k1_clear"].shape, generator=gen, device=device)
    cw, abi, abl = modes["compact"][1][0][1:]
    for name, cf in (("k6_clear", (None,) * 4),
                     ("k6_compact", (cw, abi, abl, mc.cldfmc))):
        grads = rt_sweep_vjp(taut, fr, play, plev, surf, *cf, model.ngb0,
                             model.wg, ct)
        out.update({f"{name}_{i}": g for i, g in enumerate(grads)
                    if g is not None})
    return {k: v.cpu() for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args(argv)
    if args.out:
        if not torch.cuda.is_available():
            raise SystemExit("snapshot needs a CUDA device")
        torch.save(outputs(torch.device("cuda", 0)), args.out)
    if args.compare:
        a, b = (torch.load(p) for p in args.compare)
        same = a.keys() == b.keys()
        for k in a:
            eq = k in b and torch.equal(a[k], b[k])
            same &= eq
            print(f"{k}: {'bitwise equal' if eq else 'DIFFERS'}")
        print("all bitwise equal" if same else "outputs differ")
        return 0 if same else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
