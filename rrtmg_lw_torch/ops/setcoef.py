"""Pressure/temperature interpolation indices and Planck sources.

Port of ``rrtmg_lw_tpu.ops.setcoef`` (rrtmg_lw_setcoef.f90:50-434).
Integer index arithmetic replicates Fortran truncation toward zero, and
jp / laytrop come from ``log(pavel)`` here, once: the taumol kernel
takes them as inputs and never recomputes a log.

``interp_planck_blocked`` is the plain version of the Planck kernel
(``ops.planck_cuda``), ``interp_planck_vjp`` that of its backward.
With istart=16 (the band-16-only mode of a band subset) band 16's
sources come from ``totplk16`` / ``totplk16deriv``
(``band16_sources``), which the model writes over the kernel's band 16.
Index arrays returned are 0-based int32.
"""

from __future__ import annotations

import torch

from ..types import Profile, SetcoefOut
from ._autograd import plain_vjp

STPFAC = 296.0 / 1013.0


def _trunc_int(x):
    """Fortran real->integer assignment (truncate toward zero)."""
    return x.to(torch.int32)


def _planck_index(t):
    """181-entry Planck table index (1-based, clamped) + fraction.

    rrtmg_lw_setcoef.f90:173-206: ind = int(T - 159), clamped to [1, 180],
    frac = T - 159 - ind (leaves [0, 1) when clamped)."""
    ind = torch.clamp(_trunc_int(t - 159.0), 1, 180)
    frac = t - 159.0 - ind.to(t.dtype)
    return ind, frac


def _interp_planck(table, ind, frac):
    """table (181, nb); ind (...) 1-based -> (..., nb)."""
    lo = table[ind.long() - 1]
    hi = table[ind.long()]
    return lo + frac[..., None] * (hi - lo)


def band16_sources(tavel, tz, static):
    """istart=16: band 16's Planck sources at the layers (B, L) and the
    levels (B, L+1) from ``totplk16``, which integrates 2600-3250 cm-1
    only (setcoef.f90:233-251); level 0 keeps ``totplnk``'s slope, as the
    JAX package has it (``lev0_16``)."""
    dtype = tavel.dtype
    totplk16 = static["totplk16"].to(dtype)
    totplnk16 = static["totplnk"].to(dtype)[:, 15]
    p16lay = _interp16(totplk16, *_planck_index(tavel))
    indlev, fraclev = _planck_index(tz)
    p16lev = _interp16(totplk16, indlev, fraclev)
    i0 = indlev[:, 0].long()
    lev0 = totplk16[i0 - 1] + fraclev[:, 0] * (totplnk16[i0]
                                               - totplnk16[i0 - 1])
    return p16lay, torch.cat([lev0[:, None], p16lev[:, 1:]], dim=1)


def _interp16(table, ind, frac):
    """table (181,); ind (...) 1-based -> (...)."""
    lo = table[ind.long() - 1]
    hi = table[ind.long()]
    return lo + frac * (hi - lo)


def interp_planck_blocked(temp_t, totplnk):
    """(N, B) temperatures -> (N, 16, B) Planck sources: the plain
    version of ``planck_cuda.planck_interp_blocked``."""
    ind, frac = _planck_index(temp_t)
    return _interp_planck(totplnk.to(temp_t.dtype), ind,
                          frac).permute(0, 2, 1).contiguous()


def interp_planck_vjp(temp_t, totplnk, ct):
    """ct (N, 16, B) -> the cotangent of temp_t (N, B): the plain version
    of ``planck_cuda.planck_interp_vjp`` (the table slope at the taps
    the forward used, summed over bands against ct)."""
    return plain_vjp(interp_planck_blocked, (temp_t, totplnk),
                     (True, False), (ct,))[0]


def setcoef(prof: Profile, static: dict, *, istart: int = 1, idrv: int = 0,
            planck: bool = True) -> SetcoefOut:
    """static: tensors preflog(59), tref(59), chi_mls(7, 59),
    totplnk(181, 16), totplnkderiv(181, 16), totplk16(181),
    totplk16deriv(181).

    ``planck=False`` leaves planklay/planklev as None, for callers that
    interpolate them with the Planck kernel in its own layout (and, at
    istart=16, place ``band16_sources`` in band 16 themselves)."""
    dtype = prof.pavel.dtype
    totplnk = static["totplnk"].to(dtype)
    totplnkd = static["totplnkderiv"].to(dtype)
    preflog = static["preflog"].to(dtype)
    tref = static["tref"].to(dtype)
    chi = static["chi_mls"].to(dtype)

    pavel, tavel, tz, tbound = prof.pavel, prof.tavel, prof.tz, prof.tbound

    # ----- Planck sources --------------------------------------------------
    indb, fracb = _planck_index(tbound)                 # (B,)
    planklay = planklev = None
    if planck:
        planklay = _interp_planck(totplnk, *_planck_index(tavel))
        planklev = _interp_planck(totplnk, *_planck_index(tz))
    plankbnd = prof.semiss * _interp_planck(totplnk, indb, fracb)
    dplankbnd = prof.semiss * _interp_planck(totplnkd, indb, fracb)
    if istart == 16:
        # band-16-only mode (setcoef.f90:233-251)
        sem16 = prof.semiss[:, 15:16]
        plankbnd = torch.cat([plankbnd[:, :15], sem16 * _interp16(
            static["totplk16"].to(dtype), indb, fracb)[:, None]], dim=1)
        dplankbnd = torch.cat([dplankbnd[:, :15], sem16 * _interp16(
            static["totplk16deriv"].to(dtype), indb, fracb)[:, None]],
            dim=1)
        if planck:
            p16lay, p16lev = band16_sources(tavel, tz, static)
            planklay = torch.cat([planklay[..., :15], p16lay[..., None]],
                                 dim=-1)
            planklev = torch.cat([planklev[..., :15], p16lev[..., None]],
                                 dim=-1)

    # ----- pressure / temperature interpolation ----------------------------
    plog = torch.log(pavel)
    jp = torch.clamp(_trunc_int(36.0 - 5.0 * (plog + 0.04)), 1, 58)  # 1-based
    jpl = jp.long()
    preflog_jp = preflog[jpl - 1]
    tref_jp = tref[jpl - 1]
    tref_jp1 = tref[jpl]
    fp = 5.0 * (preflog_jp - plog)
    jt = torch.clamp(_trunc_int(3.0 + (tavel - tref_jp) / 15.0), 1, 4)
    ft = (tavel - tref_jp) / 15.0 - (jt - 3).to(dtype)
    jt1 = torch.clamp(_trunc_int(3.0 + (tavel - tref_jp1) / 15.0), 1, 4)
    ft1 = (tavel - tref_jp1) / 15.0 - (jt1 - 3).to(dtype)

    water = prof.wkl[..., 0] / prof.coldry
    scalefac = pavel * STPFAC / tavel
    lower = plog > 4.56                                  # laytrop split

    forfac = scalefac / (1.0 + water)
    fac_lo = (332.0 - tavel) / 36.0
    indfor_lo = torch.clamp(_trunc_int(fac_lo), 1, 2)
    forfrac_lo = fac_lo - indfor_lo.to(dtype)
    fac_hi = (tavel - 188.0) / 36.0
    indfor = torch.where(lower, indfor_lo, 3)
    forfrac = torch.where(lower, forfrac_lo, fac_hi - 1.0)

    selffac = water * forfac
    fself = (tavel - 188.0) / 7.2
    indself = torch.clamp(_trunc_int(fself) - 7, 1, 9)
    selffrac = fself - (indself + 7).to(dtype)

    scaleminor = pavel / tavel
    scaleminorn2 = scaleminor * (prof.wbrodl
                                 / (prof.coldry + prof.wkl[..., 0]))
    fminor = (tavel - 180.8) / 7.2
    indminor = torch.clamp(_trunc_int(fminor), 1, 18)
    minorfrac = fminor - indminor.to(dtype)

    # reference-atmosphere mixing-ratio ratios at jp, jp+1 (1-based)
    def rat(g1, g2):
        a = chi[g1 - 1][jpl - 1] / chi[g2 - 1][jpl - 1]
        b = chi[g1 - 1][jpl] / chi[g2 - 1][jpl]
        return a, b

    rat_h2oco2, rat_h2oco2_1 = rat(1, 2)
    rat_h2oo3, rat_h2oo3_1 = rat(1, 3)
    rat_h2on2o, rat_h2on2o_1 = rat(1, 4)
    rat_h2och4, rat_h2och4_1 = rat(1, 6)
    rat_n2oco2, rat_n2oco2_1 = rat(4, 2)
    rat_o3co2, rat_o3co2_1 = rat(3, 2)

    # column amounts (scaled by 1e-20); zero -> 1e-32*coldry substitution
    def col(i, subst=True):
        c = 1.0e-20 * prof.wkl[..., i]
        if subst:
            c = torch.where(c == 0.0, 1.0e-32 * prof.coldry, c)
        return c

    colh2o = col(0, subst=False)
    compfp = 1.0 - fp
    return SetcoefOut(
        laytrop_mask=lower,
        jp=jp - 1, jt=jt - 1, jt1=jt1 - 1,
        planklay=planklay, planklev=planklev, plankbnd=plankbnd,
        dplankbnd_dt=dplankbnd,
        colh2o=colh2o, colco2=col(1), colo3=col(2), coln2o=col(3),
        colco=col(4), colch4=col(5), colo2=col(6, subst=False),
        colbrd=1.0e-20 * prof.wbrodl,
        fac00=compfp * (1.0 - ft), fac01=fp * (1.0 - ft1),
        fac10=compfp * ft, fac11=fp * ft1,
        rat_h2oco2=rat_h2oco2, rat_h2oco2_1=rat_h2oco2_1,
        rat_h2oo3=rat_h2oo3, rat_h2oo3_1=rat_h2oo3_1,
        rat_h2on2o=rat_h2on2o, rat_h2on2o_1=rat_h2on2o_1,
        rat_h2och4=rat_h2och4, rat_h2och4_1=rat_h2och4_1,
        rat_n2oco2=rat_n2oco2, rat_n2oco2_1=rat_n2oco2_1,
        rat_o3co2=rat_o3co2, rat_o3co2_1=rat_o3co2_1,
        selffac=colh2o * selffac, selffrac=selffrac, indself=indself - 1,
        forfac=colh2o * forfac, forfrac=forfrac, indfor=indfor - 1,
        minorfrac=minorfrac, scaleminor=scaleminor,
        scaleminorn2=scaleminorn2, indminor=indminor - 1)
