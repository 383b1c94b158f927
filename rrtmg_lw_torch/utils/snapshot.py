"""Kernel outputs of one checkout, to hold two checkouts bitwise equal.

    PYTHONPATH=<checkout> python rrtmg_lw_torch/utils/snapshot.py --out A.pt
    python rrtmg_lw_torch/utils/snapshot.py --compare A.pt B.pt

``--out`` runs, on the card, K1 in its clear, compact, banded and
maxrand modes at idrv=0 and K6 in its clear and compact modes on the
inputs of ``chip_smoke.py``'s phase 3 (``utils/profiling.py``'s
``mcica_cloudy`` and ``band_cloudy`` cells at B=16384, L=60; K6 on
seeded cotangents) and saves their outputs.  Run it from each checkout
(its own ``rrtmg_lw_torch`` first on the path), then ``--compare``
prints, per output, whether the two are bitwise equal, and exits
non-zero unless all are.  The imports are absolute, so ``PYTHONPATH``
picks the checkout whose kernels run; only entry points that every
checkout since the deterministic-cloud slice has are used.
"""

from __future__ import annotations

import argparse
import sys

import torch


def outputs(device) -> dict:
    from rrtmg_lw_torch import LWConfig, make_model
    from rrtmg_lw_torch.ops import cldprop, rtrn, rtrnmr
    from rrtmg_lw_torch.ops.inatm import inatm
    from rrtmg_lw_torch.ops.rtrn_cuda import (rt_fluxes_banded,
                                              rt_fluxes_blocked,
                                              rt_fluxes_maxrand, rt_sweep_vjp)
    from rrtmg_lw_torch.ops.setcoef import interp_planck_blocked, setcoef
    from rrtmg_lw_torch.utils.profiling import cell_inputs
    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False), device=device)
    atm, mc = cell_inputs("mcica_cloudy", device)
    _, bc = cell_inputs("band_cloudy", device)
    prof = inatm(atm, torch.float32)
    static = model.static_tensors()
    sc = setcoef(prof, static, planck=False)
    tg, fr = model.engine.blocked(sc, prof)
    taut = tg + prof.taua.permute(1, 2, 0)[:, model.ngb0.long(), :]
    play, plev = (interp_planck_blocked(t.t().contiguous(), model.totplnk)
                  for t in (prof.tavel, prof.tz))
    args = (taut, fr, play, plev, sc.plankbnd, prof.semiss, prof.pwvcm,
            model.ngb0, model.wg)
    abi, abl = cldprop.ice_liq_coeffs_blocked(mc.reicmc, mc.relqmc, 3, 1,
                                              static)
    cw = torch.stack([mc.ciwp.t(), mc.clwp.t()], 1).contiguous()
    taucb, _ = cldprop.cldprop_banded_blocked(bc, static, inflag=2,
                                              iceflag=3, liqflag=1)
    out = {"k1_clear": rt_fluxes_blocked(*args),
           "k1_compact": rt_fluxes_blocked(*args, (mc.cldfmc, cw, abi, abl)),
           "k1_banded": rt_fluxes_banded(*args, bc.cldfrac.t().contiguous(),
                                         taucb),
           "k1_maxrand": rt_fluxes_maxrand(
               *args, rtrnmr.overlap_rows(bc.cldfrac), taucb)}
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm,
                          torch.float32)
    gen = torch.Generator(device=device).manual_seed(5)
    ct = torch.randn(out["k1_clear"].shape, generator=gen, device=device)
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
