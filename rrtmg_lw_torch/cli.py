"""Column-mode driver: the port's counterpart of ``rrtmg_lw_tpu.cli``, the
reference standalone program ``rrtmg_lw`` (src/rrtmg_lw.1col.f90:80-736).

Reads INPUT_RRTM (+ IN_CLD_RRTM / IN_AER_RRTM), runs the radiation, and
writes OUTPUT_RRTM in the reference format.  The model is the port's
``make_model`` in float64 with the lookup tables (``use_lut=True``, the
plain sweep on either device), as the JAX CLI runs it.  McICA mode
performs the 200-sample statistical loop (:460-471) with the exact
Mersenne-Twister sub-column generator (irng=1, permuteseed = sample
index + 1, :483; ``ops.mcica.generate_stochastic_clouds_ref``, bit for
bit the JAX CLI's sub-columns), all samples in one batched call.

It runs on the CUDA device unless asked for another (``--device cpu``,
``run_case(..., device="cpu")``).

Run:  python -m rrtmg_lw_torch.cli INPUT_RRTM [-o OUTPUT_RRTM]
          [--cld IN_CLD_RRTM] [--aer IN_AER_RRTM] [--nmca N]
          [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

NMCA = 200     # rrtmg_lw.1col.f90:460


def run_case(case, iplon: int = 1, nmca: int = NMCA,
             return_raw: bool = False, device=None):
    """Run one parsed ColumnCase on ``device`` (the CUDA device when
    None); returns the list of formatted output blocks (and, with
    ``return_raw``, the unformatted per-block flux arrays and the device
    they were computed on)."""
    from . import LWConfig, make_model
    from .config import resolve_device
    from .io.column_output import format_flux_table
    from .ops import mcica
    from .ops.cldprop import NGB0
    from .types import BandClouds, McicaClouds, Profile

    device = resolve_device(device)
    L = case.nlayers
    imca = case.imca
    B = nmca if imca == 1 else 1

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=device)

    def rep(x):
        a = t(x)
        return a[None].expand((B,) + a.shape).contiguous()

    def full(v):
        return torch.full((B,), float(v), dtype=torch.float64, device=device)

    prof = Profile(
        pavel=rep(case.pavel), tavel=rep(case.tavel),
        pz=rep(case.pz), tz=rep(case.tz), tbound=full(case.tbound),
        semiss=rep(case.semiss), coldry=rep(case.coldry),
        wkl=rep(case.wkl.T), wbrodl=rep(case.wbrodl), wx=rep(case.wx.T),
        pwvcm=full(case.pwvcm), taua=rep(case.tauaer),
        dtbound=full(case.dtbound))

    cld = case.clouds
    clouds = None
    cfg_kw = dict(icld=case.icld, idrv=case.idrv, iaer=case.iaer,
                  imca=imca, idcor=case.idcor, dtype="float64",
                  use_lut=True)
    if cld is not None:
        cfg_kw.update(inflag=cld.inflag, iceflag=cld.iceflag,
                      liqflag=cld.liqflag)

    if case.icld >= 1 and imca == 1:
        # the exact per-sample Mersenne-Twister generator on the host
        # (irng=1, rrtmg_lw.1col.f90:114; permuteseed = ims, :483)
        alpha = None
        if case.icld in (4, 5):
            alpha = mcica.get_alpha(
                torch.as_tensor(case.dz[None, :], dtype=torch.float64),
                case.icld, idcor=case.idcor, decorr_con=case.decorr_con,
                lat=np.array([case.lat]), juldat=case.juldat,
                cldfrac=torch.as_tensor(cld.cldfrac[None, :])).numpy()[0]
        per_g = {k: np.zeros((B, L, 140))
                 for k in ("cldfmc", "ciwpmc", "clwpmc", "taucmc")}
        for s in range(B):
            out = mcica.generate_stochastic_clouds_ref(
                L, case.icld, 1, case.pavel * 100.0, cld.cldfrac,
                cld.clwp, cld.ciwp, alpha, cld.tauc, changeseed=s + 1,
                ngb=NGB0 + 1)
            for k, v in per_g.items():
                v[s] = out[k].T
        clouds = McicaClouds(**{k: t(v) for k, v in per_g.items()},
                             reicmc=rep(cld.rei), relqmc=rep(cld.rel))
    elif case.icld >= 1:
        clouds = BandClouds(
            cldfrac=rep(cld.cldfrac), tauc=rep(cld.tauc.T),
            ciwp=rep(cld.ciwp), clwp=rep(cld.clwp),
            reic=rep(cld.rei), relq=rep(cld.rel))

    blocks = []
    raws = []
    if case.iout < 0:
        return (blocks, raws) if return_raw else blocks
    iout = case.iout
    iflag = iout
    models = {}
    while True:
        istart, iend = (iflag, iflag) if 1 <= iflag <= 40 else (1, 16)
        key = (istart, iend)
        if key not in models:
            models[key] = make_model(LWConfig(istart=istart, iend=iend,
                                              **cfg_kw), device=device)
        with torch.no_grad():
            fl = models[key].from_profile(prof, clouds)
        uflx, dflx, htr = (getattr(fl, n).cpu().numpy().mean(axis=0)
                           for n in ("uflx", "dflx", "hr"))
        fnet = uflx - dflx
        blocks.append(format_flux_table(istart, iend, iplon, case.pz,
                                        uflx, dflx, fnet, htr))
        raws.append(dict(istart=istart, iend=iend, uflx=uflx, dflx=dflx,
                         fnet=fnet, htr=htr, device=str(fl.uflx.device)))
        if iout <= 40 or iflag == 16:
            break
        iflag = 1 if iflag == 99 else iflag + 1
    return (blocks, raws) if return_raw else blocks


def run_files(input_path, output_path=None, cld_path=None, aer_path=None,
              nmca: int = NMCA, device=None):
    from .io.column_input import read_input_rrtm
    from .io.column_output import write_output_rrtm

    case = read_input_rrtm(input_path, cld_path=cld_path,
                           aer_path=aer_path)
    blocks = run_case(case, nmca=nmca, device=device)
    if output_path is None:
        output_path = pathlib.Path(input_path).parent / "OUTPUT_RRTM"
    write_output_rrtm(output_path, blocks)
    return output_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input", help="INPUT_RRTM file")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--cld", default=None, help="IN_CLD_RRTM path")
    p.add_argument("--aer", default=None, help="IN_AER_RRTM path")
    p.add_argument("--nmca", type=int, default=NMCA,
                   help="McICA sample count (reference: 200)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    a = p.parse_args(argv)
    out = run_files(a.input, a.output, a.cld, a.aer, nmca=a.nmca,
                    device=a.device)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
