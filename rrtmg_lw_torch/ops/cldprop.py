"""Cloud optics: McICA clouds (inflag 0/2) and per-band clouds (imca=0).

Port of ``rrtmg_lw_tpu.ops.cldprop`` (rrtmg_lw_cldprop.f90:50-295,
rrtmg_lw_cldprmc.f90:51-273).  Ice: 0 CCM3 (``absice0``, closed form),
1 Ebert-Curry 5-region (``absice1``, closed form, mapped to the bands by
``ICB``), 2 Key/Streamer (``absice2``, 43x16), 3 Fu (``absice3``,
46x16); liquid: 0 CCM3 constant (``absliq0``), 1 Hu & Stamnes
(``absliq1``, 58x16).  ``_ice_liq_coeffs`` gives the per-band
coefficients of every flag pair; on the tabulated pair (iceflag 2/3
with liqflag 1, ``tabulated``) it is the plain version of the
cloud-coefficient kernel (``ops.cldcoef_cuda``), ``ice_liq_coeffs_vjp``
that of its backward.  The closed forms run in plain PyTorch on both
impls, as the JAX package runs them on XLA (cldprop.py:206-223): the
functions below that take ``coeffs`` (the kernel's wrapper on the card)
use it for the tabulated pair only.

For McICA clouds with per-g arrays (``McicaClouds``,
``McicaCloudsBlocked``) ``cldprmc`` and ``cldprmc_blocked`` give the
per-g cloud od: inflag 0 takes the input ``taucmc``, inflag 2 the
parameterized optics; inflag 1 raises ``ValueError`` (grey optics are
not available with McICA, cldprmc.f90:191).  ``cldprmc_od`` is that
arithmetic, which the RT kernel's fused mode repeats inline.

For per-band clouds (``BandClouds``) ``cldprop`` and
``cldprop_banded_blocked`` give the od of each spectral band where the
cloud bands are statically the 16 spectral bands (``cloud_bands_static``:
inflag 0 (input od), inflag 1 (grey ``abscld1``), inflag 2 with iceflag
2/3 and liqflag 1).  The others (inflag 2 with iceflag 0/1 or liqflag 0)
have the reference's running ``ncbands``: ``cldprop_ncbands`` gives the
od in cloud-band slots and each column's final ncbands, and
``expand_cloud_bands`` maps it to the spectral bands through ``IPAT``
with the secant of the CLOUD band (rtrn.f90:252,321,343-348).

The reference hard-stops on out-of-range particle sizes
(cldprmc.f90:204-253); here sizes are clamped and a boolean
``bounds_ok`` diagnostic is returned, each flag with its own bounds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import IPAT as IPAT1
from ..types import McicaCloudsBlocked, _to_blocked, pad_g
from ._autograd import plain_vjp
from .taumol import NG

CLDMIN = 1.0e-20
# the band of each g-point, 0-based (the static tables' ngb - 1)
NGB0 = np.repeat(np.arange(len(NG)), NG)
# Ebert & Curry 5-region -> RRTM band mapping (cldprmc.f90:164), 0-based
ICB = np.array([1, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5]) - 1
# rtrn/rtrnmr cloud-band patterns (rtrn.f90:252-254), 0-based: row 0 for
# ncbands=1, row 1 for ncbands=5, row 2 for ncbands=16 (identity)
IPAT = IPAT1 - 1
# the effective ice radius each ice flag reads: (least, most or None)
ICE_BOUNDS = {0: (10.0, None), 1: (13.0, 130.0), 2: (5.0, 131.0),
              3: (5.0, 140.0)}


def tabulated(iceflag: int, liqflag: int) -> bool:
    """True for the flag pair whose coefficients the kernel (K4)
    interpolates: a tabulated ice parameterization (iceflag 2/3) with
    Hu & Stamnes liquid (liqflag 1)."""
    return iceflag in (2, 3) and liqflag == 1


def _ice_params(iceflag):
    """(table name, rmax, nmax) of a tabulated ice parameterization,
    (None, rmax, None) of a closed form (rmax None: no upper bound)."""
    if iceflag not in ICE_BOUNDS:
        raise ValueError(f"iceflag must be 0..3, got {iceflag}")
    rmax = ICE_BOUNDS[iceflag][1]
    if iceflag == 2:
        return "absice2", rmax, 43
    if iceflag == 3:
        return "absice3", rmax, 46
    return None, rmax, None


def bounds_ok(reic, relq, iceflag, liqflag=1):
    """(B, L) True where the particle sizes are inside the bounds of the
    flags' parameterizations (liqflag 0 reads no liquid radius)."""
    _ice_params(iceflag)
    rmin, rmax = ICE_BOUNDS[iceflag]
    ok = reic >= rmin
    if rmax is not None:
        ok &= reic <= rmax
    if liqflag == 1:
        ok &= (relq >= 2.5) & (relq <= 60.0)
    return ok


def _ice_region(reic, tables):
    """The Ebert-Curry coefficients of each of the 5 regions (B, L, 5),
    at reic clamped to 13..130 as jnp.clip does it (maximum, then
    minimum: half the gradient at a bound)."""
    dtype = reic.dtype
    absice1 = tables["absice1"].to(dtype)                # (2, 5)
    r = torch.minimum(torch.maximum(reic, reic.new_tensor(13.0)),
                      reic.new_tensor(130.0))
    return absice1[0] + absice1[1] / r[..., None]


def _ice_liq_coeffs(reic, relq, iceflag, liqflag, tables):
    """Per-band ice/liquid absorption coefficients, (B, L, 16) each, plus
    the bounds-ok flag (B, L)."""
    name, _, nmax = _ice_params(iceflag)
    if liqflag not in (0, 1):
        raise ValueError(f"liqflag must be 0 or 1, got {liqflag}")
    dtype = reic.dtype
    nb = (*reic.shape, 16)
    if iceflag == 0:
        absice0 = tables["absice0"].to(dtype)
        coef = absice0[0] + absice0[1] / torch.maximum(
            reic, reic.new_tensor(10.0))
        abscoice = coef[..., None].expand(nb)
    elif iceflag == 1:
        abscoice = _ice_region(reic, tables)[..., ICB]
    else:
        tab = tables[name].to(dtype)
        factor = (reic - 2.0) / 3.0
        index = factor.to(torch.int32)                   # 1-based in ref
        index = torch.where(index == nmax, nmax - 1, index)
        index = torch.clamp(index, 1, nmax - 1)
        fint = factor - index.to(dtype)
        lo, hi = tab[index.long() - 1], tab[index.long()]
        abscoice = lo + fint[..., None] * (hi - lo)

    if liqflag == 0:
        abscoliq = tables["absliq0"].to(dtype).expand(nb)
    else:
        absliq1 = tables["absliq1"].to(dtype)
        index = (relq - 1.5).to(torch.int32)
        index = torch.where(index == 0, 1, index)
        index = torch.where(index == 58, 57, index)
        index = torch.clamp(index, 1, 57)
        fint = relq - 1.5 - index.to(dtype)
        lo, hi = absliq1[index.long() - 1], absliq1[index.long()]
        abscoliq = lo + fint[..., None] * (hi - lo)
    return abscoice, abscoliq, bounds_ok(reic, relq, iceflag, liqflag)


def ice_liq_coeffs_blocked(reic, relq, iceflag, liqflag, tables):
    """(B, L) particle sizes -> abi, abl (L, 16, B): the plain version of
    ``cldcoef_cuda.ice_liq_coeffs_blocked`` (on the tabulated pair; the
    route of the closed forms on both impls)."""
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


def _coeffs(coeffs, iceflag, liqflag):
    """``coeffs`` for the tabulated pair, else the plain closed forms."""
    return coeffs if tabulated(iceflag, liqflag) else ice_liq_coeffs_blocked


def cloud_bands_static(inflag: int, iceflag: int, liqflag: int) -> bool:
    """True when the cloud bands are the 16 spectral bands for every
    cloudy layer (rrtmg_lw_cldprop.f90:191,197,229,245,278): inflag 0/1,
    or inflag 2 with a 16-band ice table and Hu & Stamnes liquid."""
    return inflag in (0, 1) or (iceflag in (2, 3) and liqflag == 1)


def _check_inflag(inflag):
    if inflag not in (0, 1, 2):
        raise ValueError(f"inflag must be 0, 1 or 2, got {inflag}")


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
    layout.  Where the cloud bands are not static it is the od without
    the running ncbands, as the JAX package's ``cldprop``: the model
    takes ``cldprop_ncbands`` there."""
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
    wrapper of the same signature (used for the tabulated pair only).
    The running-ncbands flags as ``cldprop``."""
    _check_inflag(inflag)
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
    abi_t, abl_t = _coeffs(coeffs, iceflag, liqflag)(
        clouds.reic, clouds.relq, iceflag, liqflag, tables)
    ciwp_t = clouds.ciwp.t()[:, None, :]
    clwp_t = clouds.clwp.t()[:, None, :]
    abi_t = torch.where(ciwp_t == 0.0, 0.0, abi_t)
    abl_t = torch.where(clwp_t == 0.0, 0.0, abl_t)
    tau_t = torch.where(act_t, ciwp_t * abi_t + clwp_t * abl_t, 0.0)
    return tau_t.contiguous(), bounds_ok(clouds.reic, clouds.relq, iceflag,
                                         liqflag)


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
    abi_t, abl_t = _coeffs(coeffs, iceflag, liqflag)(
        clouds.reicmc, clouds.relqmc, iceflag, liqflag, tables)
    ok = bounds_ok(clouds.reicmc, clouds.relqmc, iceflag, liqflag)
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
    wrapper of the same signature (used for the tabulated pair only)."""
    reic, relq = clouds.reicmc, clouds.relqmc
    abi_t, abl_t = _coeffs(coeffs, iceflag, liqflag)(reic, relq, iceflag,
                                                     liqflag, tables)
    return abi_t, abl_t, bounds_ok(reic, relq, iceflag, liqflag)


def cldprop_ncbands(clouds, tables: dict, *, inflag: int, iceflag: int,
                    liqflag: int):
    """``cldprop`` with the reference's running-scalar ``ncbands``
    (rrtmg_lw_cldprop.f90:173-295) for the configurations whose cloud
    bands are not statically the spectral bands (inflag=2 with iceflag
    0/1, or liqflag=0), as ``rrtmg_lw_tpu.ops.cldprop.cldprop_ncbands``.

    Each cloudy layer sets ncbands (5 for Ebert-Curry ice, 16 for a
    tabulated ice or Hu & Stamnes liquid, the ice block first) and
    writes ``taucloud(lay, 1..ncbands)`` with the value as of that
    layer: a layer whose composition sets nothing writes as many slots
    as earlier layers left, and the sweep maps the spectral bands
    through ``IPAT`` with the value the last cloudy layer left.  A
    pure-ice Ebert-Curry layer (no liquid) promotes iceind 1 -> 2
    (:263,268): its 5 regional coefficients go to cloud bands 1-5 as
    they are, not through ``ICB``.

    Returns (taucloud (B, L, 16) in cloud-band slots, ncbands (B,) int32
    in {1, 5, 16}, bounds_ok (B, L))."""
    if inflag != 2:
        raise ValueError("the running ncbands are inflag=2's; inflag 0/1 "
                         "take cldprop")
    B, L = clouds.cldfrac.shape
    dev = clouds.cldfrac.device
    active, _ = _active(clouds)
    has_ice = active & (clouds.ciwp > 0.0)
    has_liq = active & (clouds.clwp > 0.0)
    # each layer's assignment (0: none), the ice block then the liquid
    upd = torch.zeros((B, L), dtype=torch.int64, device=dev)
    if iceflag == 1:
        upd = torch.where(has_ice, 5, upd)
    elif iceflag in (2, 3):
        upd = torch.where(has_ice, 16, upd)
    if liqflag == 1:
        upd = torch.where(has_liq, 16, upd)
    # the running value: the last assignment at or below, else 1
    lay = torch.arange(L, device=dev)[None, :]
    last = torch.cummax(torch.where(upd > 0, lay, -1), dim=1).values
    ncb_lay = torch.where(last >= 0, upd.gather(1, last.clamp(min=0)), 1)

    abscoice, abscoliq, ok = _ice_liq_coeffs(clouds.reic, clouds.relq,
                                             iceflag, liqflag, tables)
    if iceflag == 1:
        # pure ice: the 5 regions in slots 1-5 (slots past 5 unused)
        region = _ice_region(clouds.reic, tables)
        pure = torch.cat([region, region[..., 4:].expand(B, L, 11)], dim=-1)
        if liqflag == 1:
            abscoice = torch.where(has_liq[..., None], abscoice, pure)
        else:
            abscoice = pure
    zero = abscoice.new_zeros(())
    abscoice = torch.where(clouds.ciwp[..., None] == 0.0, zero, abscoice)
    abscoliq = torch.where(clouds.clwp[..., None] == 0.0, zero, abscoliq)
    taucloud = (clouds.ciwp[..., None] * abscoice
                + clouds.clwp[..., None] * abscoliq)
    # the slots this layer writes; the others stay 0
    slot = torch.arange(16, device=dev)
    taucloud = torch.where(slot < ncb_lay[..., None], taucloud, zero)
    taucloud = torch.where(active[..., None], taucloud, zero)
    return taucloud, ncb_lay[:, -1].to(torch.int32), ok


def expand_cloud_bands(taucloud_cb, ncbands, sec_band, weighted=False):
    """Cloud-band od (B, L, 16) -> the od of each SPECTRAL band, with the
    reference's ``secdiff(ib)`` alias (rrtmg_lw_rtrn.f90:321,343-348: the
    od is weighted by the diffusivity secant of the cloud band, not the
    spectral band's).  ncbands (B,) from ``cldprop_ncbands``, sec_band
    the ``rtrn.secdiff`` (B, 16).

    weighted=True: the weighted od ``sec[ipat(ib)] * taucloud[ipat(ib)]``
    as the Fortran forms it, which the sweep must not weight again (the
    LUT sweep's input, ``odcld_weighted``).  weighted=False: the ratio
    prefold ``taucloud[ipat(ib)] * (sec[ipat(ib)] / sec[ib])``, which the
    sweep multiplies by the spectral band's secant (the kernels' input):
    an ulp off the weighted od, which the float64 LUT quantizer can
    resolve."""
    B, L, _ = taucloud_cb.shape
    row = (ncbands == 5).long() + 2 * (ncbands == 16).long()   # (B,)
    ipat = torch.as_tensor(IPAT, device=taucloud_cb.device)[row]
    tau_sel = taucloud_cb.gather(2, ipat[:, None, :].expand(B, L, 16))
    sec_sel = sec_band.gather(1, ipat)
    if weighted:
        return sec_sel[:, None, :] * tau_sel
    return tau_sel * (sec_sel / sec_band)[:, None, :]
