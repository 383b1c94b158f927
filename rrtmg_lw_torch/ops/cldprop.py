"""Cloud optics for McICA clouds (inflag=2).

Port of the tabulated branches of ``rrtmg_lw_tpu.ops.cldprop``
(rrtmg_lw_cldprmc.f90:210-268): Key/Streamer (iceflag 2, absice2
43x16) and Fu (iceflag 3, absice3 46x16) ice, Hu & Stamnes (liqflag 1,
absliq1 58x16) liquid.  ``_ice_liq_coeffs`` is the plain version of the
cloud-coefficient kernel (``ops.cldcoef_cuda``).  Other flags raise
``NotImplementedError``.

The reference hard-stops on out-of-range particle sizes
(cldprmc.f90:204-253); here sizes are clamped and a boolean
``bounds_ok`` diagnostic is returned.
"""

from __future__ import annotations

import torch

CLDMIN = 1.0e-20


def _ice_params(iceflag):
    """(table name, rmax, nmax) of a tabulated ice parameterization."""
    if iceflag == 2:
        return "absice2", 131.0, 43
    if iceflag == 3:
        return "absice3", 140.0, 46
    raise NotImplementedError(
        f"iceflag {iceflag} is not ported yet (iceflag 2/3 only); "
        "see ROADMAP.md Queue 1 item 10")


def _check_liqflag(liqflag):
    if liqflag != 1:
        raise NotImplementedError(
            f"liqflag {liqflag} is not ported yet (liqflag 1 only); "
            "see ROADMAP.md Queue 1 item 10")


def bounds_ok(reic, relq, iceflag):
    """(B, L) True where both particle sizes are inside the tables."""
    rmax = _ice_params(iceflag)[1]
    return (reic >= 5.0) & (reic <= rmax) & (relq >= 2.5) & (relq <= 60.0)


def _ice_liq_coeffs(reic, relq, iceflag, liqflag, tables):
    """Per-band ice/liquid absorption coefficients, (B, L, 16) each, plus
    the bounds-ok flag (B, L)."""
    name, _, nmax = _ice_params(iceflag)
    _check_liqflag(liqflag)
    dtype = reic.dtype
    tab = tables[name].to(dtype)
    absliq1 = tables["absliq1"].to(dtype)

    factor = (reic - 2.0) / 3.0
    index = factor.to(torch.int32)                       # 1-based in ref
    index = torch.where(index == nmax, nmax - 1, index)
    index = torch.clamp(index, 1, nmax - 1)
    fint = factor - index.to(dtype)
    lo, hi = tab[index.long() - 1], tab[index.long()]
    abscoice = lo + fint[..., None] * (hi - lo)

    index = (relq - 1.5).to(torch.int32)
    index = torch.where(index == 0, 1, index)
    index = torch.where(index == 58, 57, index)
    index = torch.clamp(index, 1, 57)
    fint = relq - 1.5 - index.to(dtype)
    lo, hi = absliq1[index.long() - 1], absliq1[index.long()]
    abscoliq = lo + fint[..., None] * (hi - lo)
    return abscoice, abscoliq, bounds_ok(reic, relq, iceflag)


def ice_liq_coeffs_blocked(reic, relq, iceflag, liqflag, tables):
    """(B, L) particle sizes -> abi, abl (L, 16, B): the plain version of
    ``cldcoef_cuda.ice_liq_coeffs_blocked``."""
    abi, abl, _ = _ice_liq_coeffs(reic, relq, iceflag, liqflag, tables)
    return (abi.permute(1, 2, 0).contiguous(),
            abl.permute(1, 2, 0).contiguous())


def cloud_optics_bands_blocked(clouds, tables: dict, *, iceflag: int,
                               liqflag: int, coeffs=ice_liq_coeffs_blocked):
    """Per-band ice/liquid absorption coefficients in the (L, 16, B)
    layout the RT sweep reads, plus bounds_ok (B, L).  ``coeffs`` is
    this module's plain ``ice_liq_coeffs_blocked`` or the kernel's
    wrapper of the same signature."""
    reic, relq = clouds.reicmc, clouds.relqmc
    abi_t, abl_t = coeffs(reic, relq, iceflag, liqflag, tables)
    return abi_t, abl_t, bounds_ok(reic, relq, iceflag)
