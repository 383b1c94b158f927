"""Cloud optics: McICA clouds (inflag=2) and per-band clouds (imca=0).

Port of the tabulated branches of ``rrtmg_lw_tpu.ops.cldprop``
(rrtmg_lw_cldprmc.f90:210-268): Key/Streamer (iceflag 2, absice2
43x16) and Fu (iceflag 3, absice3 46x16) ice, Hu & Stamnes (liqflag 1,
absliq1 58x16) liquid.  ``_ice_liq_coeffs`` is the plain version of the
cloud-coefficient kernel (``ops.cldcoef_cuda``), ``ice_liq_coeffs_vjp``
that of its backward.  Other flags raise
``NotImplementedError``.

For McICA clouds with per-g arrays (``McicaClouds``,
``McicaCloudsBlocked``; rrtmg_lw_cldprmc.f90:51-273) ``cldprmc`` and
``cldprmc_blocked`` give the per-g cloud od: inflag 0 takes the input
``taucmc``, inflag 2 the parameterized optics; inflag 1 raises
``ValueError`` (grey optics are not available with McICA,
cldprmc.f90:191).  ``cldprmc_od`` is that arithmetic, which the RT
kernel's fused mode repeats inline.

For per-band clouds (``BandClouds``, rrtmg_lw_cldprop.f90:50-295)
``cldprop`` and ``cldprop_banded_blocked`` cover the configurations
whose cloud bands are statically the 16 spectral bands
(``cloud_bands_static``): inflag 0 (input od), inflag 1 (grey
``abscld1``), and inflag 2 with iceflag 2/3 and liqflag 1.  The others
(the reference's running ``ncbands``) raise ``NotImplementedError``.

The reference hard-stops on out-of-range particle sizes
(cldprmc.f90:204-253); here sizes are clamped and a boolean
``bounds_ok`` diagnostic is returned.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import McicaCloudsBlocked, _to_blocked, pad_g
from ._autograd import plain_vjp
from .taumol import NG

CLDMIN = 1.0e-20
# the band of each g-point, 0-based (the static tables' ngb - 1)
NGB0 = np.repeat(np.arange(len(NG)), NG)


def _ice_params(iceflag):
    """(table name, rmax, nmax) of a tabulated ice parameterization."""
    if iceflag == 2:
        return "absice2", 131.0, 43
    if iceflag == 3:
        return "absice3", 140.0, 46
    raise NotImplementedError(
        f"iceflag {iceflag} is not ported yet (iceflag 2/3 only); "
        "see ROADMAP.md Queue 1, the remaining cloud-optics "
        "configurations")


def _check_liqflag(liqflag):
    if liqflag != 1:
        raise NotImplementedError(
            f"liqflag {liqflag} is not ported yet (liqflag 1 only); "
            "see ROADMAP.md Queue 1, the remaining cloud-optics "
        "configurations")


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


def ice_liq_coeffs_vjp(reic, relq, iceflag, liqflag, tables, ct_abi,
                       ct_abl):
    """ct_abi, ct_abl (L, 16, B) -> the cotangents of reic and relq
    (B, L) through ``ice_liq_coeffs_blocked``: the plain version of
    ``cldcoef_cuda.ice_liq_coeffs_vjp`` (K4b)."""
    return plain_vjp(lambda r, q: ice_liq_coeffs_blocked(
        r, q, iceflag, liqflag, tables), (reic, relq), (True, True),
        (ct_abi, ct_abl))


def cloud_bands_static(inflag: int, iceflag: int, liqflag: int) -> bool:
    """True when the cloud bands are the 16 spectral bands for every
    cloudy layer (rrtmg_lw_cldprop.f90:191,197,229,245,278): inflag 0/1,
    or inflag 2 with a 16-band ice table and Hu & Stamnes liquid."""
    return inflag in (0, 1) or (iceflag in (2, 3) and liqflag == 1)


def _check_static(inflag, iceflag, liqflag):
    if inflag not in (0, 1, 2):
        raise ValueError(f"inflag must be 0, 1 or 2, got {inflag}")
    if not cloud_bands_static(inflag, iceflag, liqflag):
        raise NotImplementedError(
            f"per-band clouds with inflag={inflag}, iceflag={iceflag}, "
            f"liqflag={liqflag} (the running ncbands of cldprop_ncbands / "
            "expand_cloud_bands) are not ported yet; see ROADMAP.md "
            "Queue 1, the remaining cloud-optics configurations")


def _active(clouds):
    """(B, L) cloudy-layer flag of cldprop and the total water path."""
    cwp = clouds.ciwp + clouds.clwp
    tauctot = clouds.tauc.sum(dim=-1)
    active = (clouds.cldfrac >= CLDMIN) & ((cwp >= CLDMIN)
                                           | (tauctot >= CLDMIN))
    return active, cwp


def cldprop(clouds, tables: dict, *, inflag: int, iceflag: int,
            liqflag: int):
    """Per-band cloud optical depth (B, L, 16) and bounds_ok (B, L) of
    ``BandClouds``: ``cldprop_banded_blocked`` in the JAX package's
    layout."""
    tau_t, ok = cldprop_banded_blocked(clouds, tables, inflag=inflag,
                                       iceflag=iceflag, liqflag=liqflag)
    return tau_t.permute(2, 0, 1), ok


def cldprop_banded_blocked(clouds, tables: dict, *, inflag: int,
                           iceflag: int, liqflag: int,
                           coeffs=ice_liq_coeffs_blocked):
    """Per-band cloud optical depth of ``BandClouds`` in the (L, 16, B)
    layout the RT sweep reads, taucb_t, and bounds_ok (B, L); ``tables``
    holds the cloud tables and ``abscld1``.  ``coeffs`` (inflag 2) is
    this module's plain ``ice_liq_coeffs_blocked`` or the kernel's
    wrapper of the same signature."""
    _check_static(inflag, iceflag, liqflag)
    B, L = clouds.cldfrac.shape
    active, cwp = _active(clouds)
    act_t = active.t()[:, None, :]                       # (L, 1, B)
    if inflag == 0:
        tau_t = torch.where(act_t, clouds.tauc.permute(1, 2, 0), 0.0)
        return tau_t.contiguous(), torch.ones_like(active)
    if inflag == 1:
        grey = (tables["abscld1"] * cwp).t()[:, None, :].expand(L, 16, B)
        return (torch.where(act_t, grey, 0.0).contiguous(),
                torch.ones_like(active))
    abi_t, abl_t = coeffs(clouds.reic, clouds.relq, iceflag, liqflag, tables)
    ciwp_t = clouds.ciwp.t()[:, None, :]
    clwp_t = clouds.clwp.t()[:, None, :]
    abi_t = torch.where(ciwp_t == 0.0, 0.0, abi_t)
    abl_t = torch.where(clwp_t == 0.0, 0.0, abl_t)
    tau_t = torch.where(act_t, ciwp_t * abi_t + clwp_t * abl_t, 0.0)
    return tau_t.contiguous(), bounds_ok(clouds.reic, clouds.relq, iceflag)


def cldprmc_od(cldf, ciwp, clwp, tauc, absc_i, absc_l):
    """Per-g in-cloud optical depth (rrtmg_lw_cldprmc.f90:128-142): the
    water paths times their band's absorption coefficients where the
    g-point holds cloud, else the input od ``tauc``; every argument has
    the per-g shape (the coefficients already gathered by band)."""
    absc_i = torch.where(ciwp == 0.0, 0.0, absc_i)
    absc_l = torch.where(clwp == 0.0, 0.0, absc_l)
    cwp = ciwp + clwp
    active = (cldf >= CLDMIN) & ((cwp >= CLDMIN) | (tauc >= CLDMIN))
    return torch.where(active, ciwp * absc_i + clwp * absc_l, tauc)


def _check_mcica_inflag(inflag):
    if inflag == 1:
        raise ValueError("INFLAG=1 not available with McICA "
                         "(cldprmc.f90:191)")
    if inflag not in (0, 2):
        raise ValueError(f"inflag must be 0, 1 or 2, got {inflag}")


def cldprmc(clouds, tables: dict, *, inflag: int, iceflag: int,
            liqflag: int):
    """Per-g cloud optical depth (B, L, 140) and bounds_ok (B, L) of
    ``McicaClouds``."""
    _check_mcica_inflag(inflag)
    if inflag == 0:
        return clouds.taucmc, torch.ones(clouds.reicmc.shape,
                                          dtype=torch.bool,
                                          device=clouds.reicmc.device)
    ai, al, ok = _ice_liq_coeffs(clouds.reicmc, clouds.relqmc, iceflag,
                                 liqflag, tables)
    return cldprmc_od(clouds.cldfmc, clouds.ciwpmc, clouds.clwpmc,
                      clouds.taucmc, ai[..., NGB0], al[..., NGB0]), ok


def cldprmc_blocked(clouds, tables: dict, *, inflag: int, iceflag: int,
                    liqflag: int, coeffs=ice_liq_coeffs_blocked):
    """``cldprmc`` in the RT kernel's padded (L, 144, B) layout:
    (taucmc_t, cldfmc_t, bounds_ok), pad rows zero.  ``McicaClouds``
    (B, L, 140) are relaid once; ``McicaCloudsBlocked`` are used as they
    are (padded when they arrive with 140 rows).  ``coeffs`` as in
    ``cldprop_banded_blocked``."""
    _check_mcica_inflag(inflag)
    t = pad_g if isinstance(clouds, McicaCloudsBlocked) else _to_blocked
    cldf_t = t(clouds.cldfmc)
    if inflag == 0:
        return t(clouds.taucmc), cldf_t, torch.ones(
            clouds.reicmc.shape, dtype=torch.bool,
            device=clouds.reicmc.device)
    abi_t, abl_t = coeffs(clouds.reicmc, clouds.relqmc, iceflag, liqflag,
                          tables)
    ok = bounds_ok(clouds.reicmc, clouds.relqmc, iceflag)
    if isinstance(clouds, McicaCloudsBlocked):
        # pad rows gather band 0; their cldfmc and taucmc are zero
        G = clouds.cldfmc.shape[1]
        ngb = torch.as_tensor(np.pad(NGB0, (0, G - len(NGB0))),
                              device=abi_t.device)
        tau = cldprmc_od(clouds.cldfmc, clouds.ciwpmc, clouds.clwpmc,
                         clouds.taucmc, abi_t.index_select(1, ngb),
                         abl_t.index_select(1, ngb))
    else:
        tau = cldprmc_od(clouds.cldfmc, clouds.ciwpmc, clouds.clwpmc,
                         clouds.taucmc, abi_t.permute(2, 0, 1)[..., NGB0],
                         abl_t.permute(2, 0, 1)[..., NGB0])
    return t(tau), cldf_t, ok


def cloud_optics_bands_blocked(clouds, tables: dict, *, iceflag: int,
                               liqflag: int, coeffs=ice_liq_coeffs_blocked):
    """Per-band ice/liquid absorption coefficients in the (L, 16, B)
    layout the RT sweep reads, plus bounds_ok (B, L).  ``coeffs`` is
    this module's plain ``ice_liq_coeffs_blocked`` or the kernel's
    wrapper of the same signature."""
    reic, relq = clouds.reicmc, clouds.relqmc
    abi_t, abl_t = coeffs(reic, relq, iceflag, liqflag, tables)
    return abi_t, abl_t, bounds_ok(reic, relq, iceflag)
