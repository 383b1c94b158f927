"""Longwave radiative transfer: linear-in-tau level recurrence.

Port of ``rrtmg_lw_tpu.ops.rtrn`` (rtrnmc.f90:51-595 / rtrn.f90:51-606,
random overlap and McICA).  The optical-depth factors come in the
closed form (``use_lut=False``: exp with the two-division Planck
transition ``1 - 2 (1/od - e/(1-e))``) or, where the caller passes the
lookup tables ``luts`` (``ops.tables``; ``use_lut=True``), from the
10001-entry tables at the Pade index ``int(TBLINT * od / (BPADE + od) +
0.5)``, the gas od quantized through ``tau_tbl`` in the thick regime
(rtrnmc.f90:361-425).  The kernels have no table mode: the model runs
``use_lut=True`` on these plain sweeps, as the JAX package runs it on
its XLA sweep.  A band subset (``istart``/``iend``) is the sweep over
the selected g-points: ``ngb0`` and ``wg`` cut to them (``g_select``).
Every quantity that does not depend on the running radiance is computed
elementwise over (B, L, G) first; the sweeps are Python loops over
levels carrying only the radiance (B, G).  With idrv=1 (a
``dplankbnd_dt`` given) the up sweep also carries the derivative of
the upward radiance with respect to the surface temperature and its
clear twin (rtrnmc.f90:495-527), as the JAX package computes them: in a
cloudy layer the random-overlap blend of the cloudy and clear
transmittances, in the maxrand sweep too.

``rt_sweep_blocked`` is the plain version of the RT sweep kernel
(``ops.rtrn_cuda``): the same function on the kernel's layouts, with
the per-column surface rows (``surf_rows``) as one input, in its clear,
compact McICA, per-g cldf-odcld and fused (cldprmc inline) modes;
``rt_sweep_vjp`` is the plain version of its backward kernel.
``rt_sweep_banded`` and ``rt_sweep_maxrand`` are the plain versions of
the kernel's two deterministic-cloud modes: random overlap of per-band
clouds (icld=1, rtrn.f90) and maximum-random overlap (icld 2/3,
rtrnmr.f90, the sub-stream recursion ``_sweep_maxrand`` fed by the
overlap rows of ``ops.rtrnmr``); ``rt_sweep_maxrand(..., radiances=True)``
and ``rt_sweep_maxrand_vjp`` are those of the maxrand gradient's kernels
(K1 keeping its state, K6 maxrand), and ``rt_sweep_banded(...,
radiances=True)``, ``rt_sweep_blocked(..., radiances=True)`` with per-g
fields, ``rt_sweep_banded_vjp`` and ``rt_sweep_g_vjp`` those of the
banded, fused and cldf-odcld gradient's (K1 keeping its radiances and,
fused and cldf-odcld, the cloudy-layer words ``cloudy_words`` packs; K6
in those modes).  ``ddt_adjoint`` and ``rt_sweep_ddt_vjp`` are the plain
twin of K6's d/dT part at idrv=1, the adjoint of the d/dT up sweep in
every mode, written as the kernels run it.

The ``rt_fluxes_*`` functions take ``taua_t`` (L, 16, B) with taut_t and
fracs_t in reduced spectral storage (``spec_codec``): they decode them
and add the aerosol od of each g's band first, as K1 does in that
storage; in float32 taut_t holds taug + taua already.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import (BPADE, FLUXFAC, NTBL, REC_6, SECDIFF_A0,
                         SECDIFF_A1, SECDIFF_A2, SECDIFF_FIXED, TBLINT,
                         WTDIFF)
from ..types import NGPT
from ._autograd import plain_vjp
from .cldprop import CLDMIN, cldprmc_od
from .spec_codec import spec_inputs

# a layer holds a per-band cloud where cldfrac >= CLOUD_GATE (icld 1-3;
# the JAX package's gate_thresh, models/radiation.py:335)
CLOUD_GATE = 1.0e-6
# rows of the (L, 16, B) overlap rows (rtrnmr.overlap_rows) of the
# maxrand mode: cldfrac, istcld (up restart), istcldd (down restart),
# iclddn (cloud at or above), the 6 down factors, the 6 up factors
ROW_CLDF, ROW_IST_UP, ROW_IST_DN, ROW_ICLDDN = 0, 1, 2, 3
ROWS_DN, ROWS_UP = slice(4, 10), slice(10, 16)
NROWS = 16


class RTOut(NamedTuple):
    totuflux: torch.Tensor     # (B, L+1)
    totdflux: torch.Tensor
    htr: torch.Tensor          # (B, L)
    totuclfl: torch.Tensor
    totdclfl: torch.Tensor
    htrc: torch.Tensor
    dtotuflux_dt: Optional[torch.Tensor] = None     # (B, L+1), idrv=1
    dtotuclfl_dt: Optional[torch.Tensor] = None


def secdiff(pwvcm, dtype):
    """Per-band diffusivity secant (B, 16); rtrnmc.f90:273-281."""
    def c(x):
        return torch.as_tensor(x).to(pwvcm.device, dtype)
    var = c(SECDIFF_A0)[None, :] + c(SECDIFF_A1)[None, :] * torch.exp(
        c(SECDIFF_A2)[None, :] * pwvcm.to(dtype)[:, None])
    var = torch.clamp(var, 1.50, 1.80)
    fixed = torch.as_tensor(SECDIFF_FIXED, device=pwvcm.device)
    return torch.where(fixed[None, :], torch.full_like(var, 1.66), var)


def _lut_index(x):
    """The lookup-table index of od x >= 0, ``int(TBLINT * x / (BPADE +
    x) + 0.5)`` truncated (rtrnmc.f90:403)."""
    return (TBLINT * (x / (BPADE + x)) + 0.5).to(torch.int64)


def _lut_take(x, luts, names):
    """The tables ``names`` of ``luts`` at x's index, NaN where it falls
    off the table (x < 0, where the small-od branch is taken, or NaN), as
    jnp.take's fill mode gives in the JAX package."""
    it = _lut_index(x)
    off = (it < 0) | (it > NTBL)
    it = it.clamp(0, NTBL)
    nan = x.new_tensor(float("nan"))
    return [torch.where(off, nan, luts[n][it]) for n in names]


def _gas_factors(od, luts=None):
    """atrans, tf_gas (Planck transition), od_eff (rtrnmc.f90:361-425):
    closed form, or the table branch where ``luts`` (``tau_tbl``,
    ``exp_tbl``, ``tfn_tbl`` tensors) is given, whose od_eff is od
    quantized through tau_tbl (:403-405)."""
    small = od <= 0.06
    if luts is not None:
        e, tf, tau = _lut_take(od, luts, ("exp_tbl", "tfn_tbl", "tau_tbl"))
        return (torch.where(small, od - 0.5 * od * od, 1.0 - e),
                torch.where(small, REC_6 * od, tf),
                torch.where(small, od, tau))
    # clamp at the branch threshold keeps the unselected branch finite
    od_safe = torch.clamp(od, min=0.06)
    e_safe = torch.exp(-od_safe)
    atrans = torch.where(small, od - 0.5 * od * od, 1.0 - e_safe)
    tf = torch.where(small, REC_6 * od,
                     1.0 - 2.0 * (1.0 / od_safe - e_safe / (1.0 - e_safe)))
    return atrans, tf, od


def _tot_factors(odtot, luts=None):
    """atot, tf_tot for the gas+cloud optical depth, closed form or from
    ``luts``."""
    small = odtot < 0.06
    if luts is not None:
        e, tf = _lut_take(odtot, luts, ("exp_tbl", "tfn_tbl"))
        return (torch.where(small, odtot - 0.5 * odtot * odtot, 1.0 - e),
                torch.where(small, REC_6 * odtot, tf))
    ots = torch.clamp(odtot, min=0.06)
    e_safe = torch.exp(-ots)
    return (torch.where(small, odtot - 0.5 * odtot * odtot, 1.0 - e_safe),
            torch.where(small, REC_6 * odtot,
                        1.0 - 2.0 * (1.0 / ots - e_safe / (1.0 - e_safe))))


def precompute(taut, cldf_g, odcld_g, cld_gate, fracs, planklay, planklev,
               secd, ngb0, luts=None, odcld_weighted=False):
    """Elementwise (B, L, G) precompute of the RT sweep; secd is the
    per-band diffusivity secant (B, 16), ``luts`` as ``_gas_factors``.
    ``odcld_weighted``: odcld_g already carries its secant (the running
    ncbands clouds weight it by the CLOUD band's, rtrn.f90:321,
    ``cldprop.expand_cloud_bands(..., weighted=True)``), so it is not
    multiplied by the g-point's band's here."""
    secd_g = secd[:, ngb0]                               # (B, G)
    # maximum, not clamp: at od = 0 (g-points whose taut is zero) both
    # sides get half the gradient, as jnp.maximum gives in JAX
    od = secd_g[:, None, :] * taut
    od = torch.maximum(od, torch.zeros_like(od))
    atrans, tf_gas, od_eff = _gas_factors(od, luts)

    blay = planklay[..., ngb0]                           # (B, L, G)
    dpup = planklev[:, 1:, :][..., ngb0] - blay
    dpdn = planklev[:, :-1, :][..., ngb0] - blay

    bbd = fracs * (blay + tf_gas * dpdn)
    bbugas = fracs * (blay + tf_gas * dpup)
    gassrc_dn = atrans * bbd

    zero = torch.zeros_like(taut)
    odcld_eff = torch.where(
        cld_gate, odcld_g if odcld_weighted else secd_g[:, None, :] * odcld_g,
        zero)
    abscld = 1.0 - torch.exp(-odcld_eff)
    efclfrac = torch.where(cld_gate, abscld * cldf_g, zero)

    atot, tf_tot = _tot_factors(od_eff + odcld_eff, luts)
    bbdtot = fracs * (blay + tf_tot * dpdn)
    bbutot = fracs * (blay + tf_tot * dpup)
    return dict(atrans=atrans, atot=atot, bbd=bbd, bbugas=bbugas,
                bbutot=bbutot, bbdtot=bbdtot, gassrc_dn=gassrc_dn,
                efclfrac=efclfrac)


def band_weights(delwave, ngb0):
    """Per-g flux weights WTDIFF * delwave(band) * FLUXFAC (numpy)."""
    return WTDIFF * np.asarray(delwave, np.float64)[ngb0] * FLUXFAC


def heating(fnet, pz, heatfac_val):
    """(B, L+1) net flux -> (B, L) heating rate (K/day)."""
    dp = pz[:, :-1] - pz[:, 1:]
    return heatfac_val * (fnet[:, :-1] - fnet[:, 1:]) / dp


def rt_out(fluxes, pz, heatfac_val):
    """RTOut from (up, down, clear up, clear down[, d up/dT, d clear
    up/dT]) (B, L+1)."""
    up, dn, upc, dnc = fluxes[:4]
    return RTOut(up, dn, heating(up - dn, pz, heatfac_val), upc, dnc,
                 heating(upc - dnc, pz, heatfac_val), *fluxes[4:])


def rt_random_overlap(taut, fracs, planklay, planklev, plankbnd, semiss,
                      pwvcm, pz, cldf_g, odcld_g, *, cloudy_lay, cld_gate,
                      static, luts=None, use_lut=False, heatfac_val, idrv=0,
                      dplankbnd_dt=None, istart=1, iend=16,
                      odcld_weighted=False):
    """Random-overlap / McICA RT (rtrnmc.f90 semantics) over the g-points
    of bands istart..iend.  Cloud inputs per g-point: cldf_g, odcld_g
    (B, L, G).  ``use_lut``: the table factors from ``luts`` (the
    ``tables.LUT_NAMES`` tensors).  idrv=1 also gives d(up)/dT_sfc from ``dplankbnd_dt``
    (B, 16)."""
    gsel = g_select(static, istart, iend)
    if taut.shape[-1] != len(gsel):
        raise ValueError("taut g-dim must match selected bands")
    ngb0, wg = (x[gsel] for x in g_tables(static, taut.device, taut.dtype))
    return rt_out(_sweep(taut, fracs, planklay, planklev, plankbnd, semiss,
                         secdiff(pwvcm, taut.dtype), cldf_g, odcld_g,
                         cloudy_lay, cld_gate, ngb0, wg,
                         luts=luts if use_lut else None,
                         dplankbnd_dt=dplankbnd_dt if idrv else None,
                         odcld_weighted=odcld_weighted),
                  pz, heatfac_val)


def g_tables(static, device, dtype):
    """Band of each g-point (int32, 0-based) and its flux weight."""
    ngb0 = np.asarray(static["ngb"]) - 1
    return (torch.as_tensor(ngb0, dtype=torch.int32, device=device),
            torch.as_tensor(band_weights(static["delwave"], ngb0)).to(
                device, dtype))


def g_select(static, istart=1, iend=16):
    """The g-points (numpy int64) of bands istart..iend (1-based), as the
    JAX model's ``_gselect``."""
    ngb0 = np.asarray(static["ngb"]) - 1
    return np.nonzero((ngb0 >= istart - 1) & (ngb0 <= iend - 1))[0]


def _ddt_step(dlu, dclru, a, ato, cf, cly, twin):
    """One layer of the d/dT up sweep (idrv=1; rtrnmc.f90:495-527): the
    derivative dlu of the upward radiance and its clear twin dclru,
    through the layer's gas transmittance 1 - a, and in a cloudy layer
    (cly) through the blend of the cloudy (1 - ato) and clear ones with
    the cloud fraction cf."""
    dn = torch.where(cly, dlu * cf * (1.0 - ato) + dlu * (1.0 - cf) * (1.0 - a),
                     dlu * (1.0 - a))
    return dn, torch.where(twin, dclru * (1.0 - a), dn)


def ddt_adjoint(at, atot, cf, cly, anyc, d0, wg, ct_ddt, saved=None):
    """The adjoint of the d/dT up sweep (``_ddt_step`` from d0 at the
    surface) as K6 runs it at idrv=1, the plain twin of its d/dT part.
    at, atot, cf (B, L, G) each layer's gas and total absorptivity and
    cloud fraction, cly (B, L, 1|G) its cloudy gate, anyc (B, 1) the clear
    twin's, d0 (B, G) the surface seed fracs[0] x dplankbnd_dt, wg (G,),
    ct_ddt (2, L+1, B) the cotangents of duflx_dt and duflxc_dt ->
    cotangents of (at, atot, cf, d0).  The recursion is linear: lam, the
    cotangent of the derivative leaving each layer upward, runs from the
    top level down (the clear twin's folded into it where the column has
    no cloud, the twin then being the same), P, the derivative entering
    each layer, from the surface up, and layer l's transmittance t gets
    lam P (rtrn.cuh ddt_step_bwd).  ``saved``: (P, PC) (B, L, G), the
    derivatives entering each layer as the forward sweep kept them (K1
    SAVE's planes 4-5 in the banded, maxrand, fused, cldf-odcld and
    compact modes, ``_sweep(..., radiances=True)``'s and
    ``_sweep_maxrand``'s), read in place of running P from
    d0, as K6 reads them in those modes: lam P at each layer as lam
    reaches it, the clear twin's selected where the column has a cloud
    (PC need not be finite elsewhere)."""
    B, L, G = at.shape
    cu = ct_ddt[0].t()[..., None] * wg                   # (B, L+1, G)
    ccu = ct_ddt[1].t()[..., None] * wg
    tg = 1.0 - at
    t = torch.where(cly, cf * (1.0 - atot) + (1.0 - cf) * tg, tg)
    zero = torch.zeros_like(d0)
    lam, lamc = cu[:, L], ccu[:, L]
    lams, lamcs = [None] * L, [None] * L
    for lev in range(L - 1, -1, -1):
        lams[lev] = torch.where(anyc, lam, lam + lamc)
        lamcs[lev] = torch.where(anyc, lamc, zero)
        lam = cu[:, lev] + lams[lev] * t[:, lev]
        lamc = ccu[:, lev] + lamcs[lev] * tg[:, lev]
    ct_d0 = lam + lamc
    if saved is not None:
        p, pc = saved
        ct_t = torch.stack(lams, 1) * p
        ct_tc = torch.where(anyc[..., None], torch.stack(lamcs, 1) * pc,
                            zero[:, None])
    else:
        p = pc = d0
        ct_t, ct_tc = [], []
        for lev in range(L):
            ct_t.append(lams[lev] * p)
            ct_tc.append(lamcs[lev] * pc)
            p, pc = _ddt_step(p, pc, at[:, lev], atot[:, lev], cf[:, lev],
                              cly[:, lev], anyc)
        ct_t, ct_tc = torch.stack(ct_t, 1), torch.stack(ct_tc, 1)
    ct_at = -torch.where(cly, ct_t * (1.0 - cf), ct_t) - ct_tc
    ct_atot = torch.where(cly, -ct_t * cf, 0.0)
    ct_cf = torch.where(cly, ct_t * (at - atot), 0.0)
    return ct_at, ct_atot, ct_cf, ct_d0


def flux(rads, wg):
    """L+1 x (B, G) radiances -> (B, L+1) fluxes."""
    return torch.einsum("lbg,g->bl", torch.stack(rads), wg)


def _sweep(taut, fracs, planklay, planklev, plankbnd, semiss, secd,
           cldf_g, odcld_g, cloudy_lay, cld_gate, ngb0, wg, luts=None,
           dplankbnd_dt=None, radiances=False, odcld_weighted=False):
    """Down and up sweeps -> (up, down, clear up, clear down) (B, L+1),
    and (d up/dT, d clear up/dT) when ``dplankbnd_dt`` (B, 16) is given
    (idrv=1).  ``radiances``: (that tuple, the per-g radiances (4, L, G,
    B)): the down radiance at level l, the up radiance entering layer l
    (l = 0: after the surface reflection), and their clear twins, for
    l = 0..L-1, the ones summed into the flux rows there; at idrv=1 (6,
    L, G, B), then the d/dT derivative entering layer l and its clear
    twin (l = 0: the seed fracs[0] x dplankbnd_dt), what K1 SAVE keeps
    for the d/dT adjoint in the cloudy modes (``ddt_adjoint``'s
    ``saved``).  ``luts``, ``odcld_weighted``: as ``precompute``."""
    dtype = taut.dtype
    B, L, G = taut.shape
    ngb0 = ngb0.long()

    pre = precompute(taut, cldf_g, odcld_g, cld_gate, fracs, planklay,
                     planklev, secd, ngb0, luts, odcld_weighted)
    at, atot = pre["atrans"], pre["atot"]
    ef, cf = pre["efclfrac"], cldf_g
    cly = cloudy_lay[..., None]                          # (B, L, 1)
    # cloud-in-path-above flag per layer: reverse cumulative OR
    iclddn = torch.flip(torch.cumsum(torch.flip(cloudy_lay.int(), [1]), 1),
                        [1]) > 0                         # (B, L)
    anyc = iclddn[:, :1]                                 # (B, 1)

    # ---- downward sweep (lev = L-1 .. 0), radiance at layer bottoms ----
    zero = torch.zeros((B, G), dtype=dtype, device=taut.device)
    radld, radclrd = zero, zero
    drad = [zero] * (L + 1)
    cdrad = [zero] * (L + 1)
    for lev in range(L - 1, -1, -1):
        a, ato, bbd = at[:, lev], atot[:, lev], pre["bbd"][:, lev]
        gs = pre["gassrc_dn"][:, lev]
        rad_cld = (radld - radld * (a + ef[:, lev] * (1.0 - a)) + gs
                   + cf[:, lev] * (pre["bbdtot"][:, lev] * ato - gs))
        rad_clr = radld + (bbd - radld) * a
        radld = torch.where(cly[:, lev], rad_cld, rad_clr)
        radclrd = torch.where(iclddn[:, lev, None],
                              radclrd + (bbd - radclrd) * a, radld)
        drad[lev], cdrad[lev] = radld, radclrd

    # ---- surface reflection ----
    rad0 = fracs[:, 0, :] * plankbnd[:, ngb0]
    reflect = 1.0 - semiss[:, ngb0]
    radlu = rad0 + reflect * radld
    radclru = rad0 + reflect * radclrd
    urad, curad = [radlu], [radclru]
    idrv = dplankbnd_dt is not None
    if idrv:
        dlu = dclru = fracs[:, 0, :] * dplankbnd_dt[:, ngb0]
        durad, dcurad = [dlu], [dclru]

    # ---- upward sweep (lev = 0 .. L-1), radiance at layer tops ----
    for lev in range(L):
        a, ato, bbu = at[:, lev], atot[:, lev], pre["bbugas"][:, lev]
        gs = bbu * a
        rad_cld = (radlu - radlu * (a + ef[:, lev] * (1.0 - a)) + gs
                   + cf[:, lev] * (pre["bbutot"][:, lev] * ato - gs))
        rad_clr = radlu + (bbu - radlu) * a
        radlu = torch.where(cly[:, lev], rad_cld, rad_clr)
        radclru = torch.where(anyc, radclru + (bbu - radclru) * a, radlu)
        urad.append(radlu)
        curad.append(radclru)
        if idrv:
            dlu, dclru = _ddt_step(dlu, dclru, a, ato, cf[:, lev],
                                   cly[:, lev], anyc)
            durad.append(dlu)
            dcurad.append(dclru)

    out = (flux(urad, wg), flux(drad, wg), flux(curad, wg),
           flux(cdrad, wg))
    out += (flux(durad, wg), flux(dcurad, wg)) if idrv else ()
    if not radiances:
        return out
    kept = (drad, urad, cdrad, curad) + ((durad, dcurad) if idrv else ())
    rads = torch.stack([torch.stack(r[:L]) for r in kept])
    return out, rads.permute(0, 1, 3, 2)


def _sweep_maxrand(taut, fracs, planklay, planklev, plankbnd, semiss, secd,
                   rows, odcld_g, ngb0, wg, dplankbnd_dt=None,
                   radiances=False, luts=None, odcld_weighted=False):
    """Maximum-random overlap sweeps (rtrnmr.f90:591-615 down, 678-703
    up) -> (up, down, clear up, clear down) (B, L+1), and the d/dT pair
    when ``dplankbnd_dt`` is given, as ``_sweep``.  rows (B, L, 16) are
    ``rtrnmr.overlap_rows`` per column; odcld_g (B, L, G) the cloud od
    of each g's band.  ``radiances``: (that tuple, the state (10 | 12, L,
    G, B)): as ``_sweep``'s four radiances, then the cloudy, clear and
    correction sub-streams (cr, kr, rr) entering layer l in the down
    sweep, then in the up sweep, and at idrv=1 the d/dT derivative
    entering layer l and its clear twin, as ``_sweep``'s.  ``luts``,
    ``odcld_weighted``: as ``precompute``."""
    dtype = taut.dtype
    B, L, G = taut.shape
    ngb0 = ngb0.long()
    cf = rows[..., ROW_CLDF]                             # (B, L)
    cloudy = cf >= CLOUD_GATE
    pre = precompute(taut, cf[..., None].expand(B, L, G), odcld_g,
                     cloudy[..., None].expand(B, L, G), fracs, planklay,
                     planklev, secd, ngb0, luts, odcld_weighted)
    at, atot = pre["atrans"], pre["atot"]
    icl = rows[..., ROW_ICLDDN] > 0.0                    # cloud at or above

    def step(rad, radc, sub, l, src, srctot, gs, ist, facs, twin):
        """Layer l of the total-sky stream (with its cloudy, clear and
        correction sub-streams) and of its clear twin."""
        cr, kr, rr = sub
        c, a, ato = cf[:, l, None], at[:, l], atot[:, l]
        fclr1, fclr2, fcld1, fcld2, fcmb1, fcmb2 = (
            f[:, None] for f in rows[:, l, facs].unbind(-1))
        st = ist[:, l, None]
        cr0 = torch.where(st, c * rad, cr)
        kr0 = torch.where(st, rad - c * rad, kr)
        rr0 = torch.where(st, 0.0, rr)
        ttot = 1.0 - ato
        cldsrc = srctot * ato
        cr1 = cr0 * ttot + c * cldsrc
        kr1 = kr0 * (1.0 - a) + (1.0 - c) * gs
        radmod = (rr0 * (fclr1 * (1.0 - a) + fcld1 * ttot)
                  - fcmb1 * gs + fcmb2 * cldsrc)
        rn = -radmod + fclr2 * (kr1 + radmod) - fcld2 * (cr1 - radmod)
        cly = cloudy[:, l, None]
        new = torch.where(cly, cr1 + kr1, rad + (src - rad) * a)
        sub = (torch.where(cly, cr1 + rn, cr), torch.where(cly, kr1 - rn, kr),
               torch.where(cly, rn, rr))
        return new, torch.where(twin, radc + (src - radc) * a, new), sub

    zero = torch.zeros((B, G), dtype=dtype, device=taut.device)
    ist_dn = rows[..., ROW_IST_DN] > 0.0
    rad = radc = zero
    sub = (zero, zero, zero)
    drad = [zero] * (L + 1)
    cdrad = [zero] * (L + 1)
    subs_dn = [None] * L
    for lev in range(L - 1, -1, -1):
        subs_dn[lev] = sub
        rad, radc, sub = step(rad, radc, sub, lev, pre["bbd"][:, lev],
                              pre["bbdtot"][:, lev], pre["gassrc_dn"][:, lev],
                              ist_dn, ROWS_DN, icl[:, lev, None])
        drad[lev], cdrad[lev] = rad, radc

    rad0 = fracs[:, 0, :] * plankbnd[:, ngb0]
    reflect = 1.0 - semiss[:, ngb0]
    rad = rad0 + reflect * rad
    radc = rad0 + reflect * radc
    urad, curad = [rad], [radc]
    ist_up = rows[..., ROW_IST_UP] > 0.0
    anyc = icl[:, :1]
    sub = (zero, zero, zero)
    idrv = dplankbnd_dt is not None
    if idrv:
        dlu = dclru = fracs[:, 0, :] * dplankbnd_dt[:, ngb0]
        durad, dcurad = [dlu], [dclru]
    subs_up = [None] * L
    for lev in range(L):
        bbu = pre["bbugas"][:, lev]
        subs_up[lev] = sub
        rad, radc, sub = step(rad, radc, sub, lev, bbu, pre["bbutot"][:, lev],
                              bbu * at[:, lev], ist_up, ROWS_UP, anyc)
        urad.append(rad)
        curad.append(radc)
        if idrv:
            dlu, dclru = _ddt_step(dlu, dclru, at[:, lev], atot[:, lev],
                                   cf[:, lev, None], cloudy[:, lev, None],
                                   anyc)
            durad.append(dlu)
            dcurad.append(dclru)

    out = (flux(urad, wg), flux(drad, wg), flux(curad, wg),
           flux(cdrad, wg))
    out += (flux(durad, wg), flux(dcurad, wg)) if idrv else ()
    if not radiances:
        return out
    rads = [torch.stack(r[:L]) for r in (drad, urad, cdrad, curad)]
    rads += [torch.stack([s[q] for s in subs]) for subs in (subs_dn, subs_up)
             for q in range(3)]
    if idrv:
        rads += [torch.stack(r[:L]) for r in (durad, dcurad)]
    return out, torch.stack(rads).permute(0, 1, 3, 2)


def _tb(x):
    """(L, *, B) -> (B, L, *)."""
    return x.permute(2, 0, 1)


def compact_cloud_optics(mask_t, cw_t, abi_t, abl_t, ngb0, dtype):
    """Compact McICA fields -> per-g cldf_g, odcld_g (B, L, 140).

    The cldprmc arithmetic (rrtmg_lw_cldprmc.f90:128-142) on the
    products mask x per-layer water path, as the RT kernel forms them:
    ciwp_g = ciwp * mask, clwp_g = clwp * mask, taucmc = 0."""
    G = len(ngb0)
    cldf_g = _tb(mask_t[:, :G, :]).to(dtype)
    ciwp = _tb(cw_t[:, 0:1, :]).to(dtype) * cldf_g
    clwp = _tb(cw_t[:, 1:2, :]).to(dtype) * cldf_g
    return cldf_g, cldprmc_od(cldf_g, ciwp, clwp, torch.zeros_like(cldf_g),
                              _tb(abi_t)[..., ngb0], _tb(abl_t)[..., ngb0])


def fused_cloud_optics(cldf_t, ciwp_t, clwp_t, tauc_t, abi_t, abl_t, ngb0):
    """The fused mode's per-g McICA arrays (L, 144, B) and per-band
    coefficients (L, 16, B) -> cldf_g, odcld_g (B, L, 140): cldprmc
    (inflag=2) as the RT kernel runs it inline."""
    G = len(ngb0)
    cldf, ciwp, clwp, tauc = (_tb(x[:, :G, :]) for x in
                              (cldf_t, ciwp_t, clwp_t, tauc_t))
    return cldf, cldprmc_od(cldf, ciwp, clwp, tauc, _tb(abi_t)[..., ngb0],
                            _tb(abl_t)[..., ngb0])


def surf_rows(plankbnd, semiss, pwvcm, dtype, dplankbnd_dt=None):
    """Per-column surface rows of the RT sweep, (3, 16, B): diffusivity
    secant, emissivity, surface Planck source; (4, 16, B) with the
    Planck source's temperature derivative ``dplankbnd_dt`` (idrv=1)."""
    rows = [secdiff(pwvcm, dtype).t(), semiss.t(), plankbnd.t()]
    if dplankbnd_dt is not None:
        rows.append(dplankbnd_dt.t())
    return torch.stack(rows).to(dtype).contiguous()


def _surf(surf):
    """surf rows -> secd, semiss, plankbnd (B, 16) and dplankbnd_dt
    (B, 16) or None."""
    secd, semiss, plankbnd = (s.t() for s in surf[:3])
    return secd, semiss, plankbnd, (surf[3].t() if len(surf) == 4
                                    else None)


def _g_clouds(cloud_fields, taut, ngb0):
    """cldf_g, odcld_g (B, L, 140) and the per-g gate of the cloud
    fields of ``rt_sweep_blocked``."""
    if cloud_fields is None:
        zero = torch.zeros_like(taut)
        return zero, zero, torch.zeros(taut.shape, dtype=torch.bool,
                                       device=taut.device)
    if len(cloud_fields) == 4:
        cldf_g, odcld_g = compact_cloud_optics(*cloud_fields, ngb0,
                                               taut.dtype)
    elif len(cloud_fields) == 6:
        cldf_g, odcld_g = fused_cloud_optics(*cloud_fields, ngb0)
    else:
        cldf_g, odcld_g = (_tb(x[:, :len(ngb0), :]) for x in cloud_fields)
    return cldf_g, odcld_g, cldf_g >= 0.5


def rt_sweep_blocked(taut_t, fracs_t, planklay_t, planklev_t, surf, ngb0,
                     wg, cloud_fields=None, radiances=False, luts=None):
    """Band-integrated fluxes (4, L+1, B) = [up, down, clear up, clear
    down] from the kernel layouts, and rows 4-5 = [d up/dT, d clear
    up/dT] when surf has the fourth row (idrv=1): the plain version of
    the RT sweep kernel.

    taut_t, fracs_t (L, 140, B); planklay_t (L, 16, B); planklev_t
    (L+1, 16, B); surf (3|4, 16, B) from ``surf_rows``; ngb0, wg the
    ``g_tables`` of the static tables (140,).  cloud_fields, one per
    mode (a g-point is cloudy where its cloud fraction >= 0.5):
      None: clear sky;
      compact McICA: mask (L, 144, B), cw (L, 2, B) = [ciwp, clwp],
        abi, abl (L, 16, B);
      cldf-odcld: cldf_t, odcld_t (L, 144, B), the per-g cloud fraction
        and in-cloud od (``cldprop.cldprmc_blocked``);
      fused: cldf_t, ciwp_t, clwp_t, tauc_t (L, 144, B), abi, abl
        (L, 16, B), cldprmc (inflag=2) on them.

    ``radiances``: (the fluxes, rads (2|4, L, 140, B)), the per-g
    radiances the sweep sums into flux rows at levels 0..L-1: the down
    radiance at level l, the up radiance entering layer l (l = 0: after
    the surface reflection) and, with clouds, their clear twins, then
    with clouds at idrv=1 (rads (6, L, 140, B)) the d/dT derivative
    entering layer l and its clear twin; the plain version of
    ``rtrn_cuda.rt_sweep_radiances``, what K6 reads.
    In the per-g modes (cldf-odcld, fused) also the cloudy-layer words
    of the cloud fraction (``cloudy_words``): (the fluxes, rads, words),
    the plain version of ``rtrn_cuda.rt_sweep_g_radiances``.

    ``luts``: the table factors (``use_lut=True``), which no kernel
    has.  A band subset: taut_t, fracs_t and the per-g cloud fields
    hold the selected g-points' rows only (G of them), ngb0 and wg the
    same G entries."""
    ngb0l = ngb0.long()
    taut = _tb(taut_t)
    cldf_g, odcld_g, gate = _g_clouds(cloud_fields, taut, ngb0l)
    secd, semiss, plankbnd, dpl = _surf(surf)
    res = _sweep(taut, _tb(fracs_t), _tb(planklay_t), _tb(planklev_t),
                 plankbnd, semiss, secd, cldf_g, odcld_g, gate.any(dim=-1),
                 gate, ngb0, wg, luts=luts, dplankbnd_dt=dpl,
                 radiances=radiances)
    if not radiances:
        return torch.stack(res).permute(0, 2, 1).contiguous()
    fluxes, rads = res
    out = (torch.stack(fluxes).permute(0, 2, 1).contiguous(),
           (rads[:2] if cloud_fields is None else rads).contiguous())
    if cloud_fields is not None and len(cloud_fields) in (2, 6):
        return (*out, cloudy_words(cloud_fields[0]))
    return out


def cloudy_words(cldf_t):
    """The cloudy layers of per-g cloud fractions cldf_t (L, 144, B), a
    layer cloudy for a column where any of its 140 g-points has cldf >=
    0.5 (the gate of K1 and K6 in the fused and cldf-odcld modes), packed
    as K1 keeps them for K6: int32 ((B + 31) // 32, L), bit c of word (t,
    l) column 32 t + c at layer l, zero past column B - 1."""
    L, _, B = cldf_t.shape
    n = (B + 31) // 32
    cloudy = (cldf_t[:, :NGPT] >= 0.5).any(dim=1)            # (L, B)
    bits = torch.zeros((L, n * 32), dtype=torch.int64, device=cldf_t.device)
    bits[:, :B] = cloudy
    shift = torch.arange(32, dtype=torch.int64, device=cldf_t.device)
    words = (bits.view(L, n, 32) << shift).sum(dim=-1)        # < 2**32
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32).t().contiguous()


def _band_layouts(taut_t, fracs_t, planklay_t, planklev_t, surf, taucb_t,
                  ngb0):
    """(L, *, B) kernel inputs -> (B, L, *) sweep inputs, the band cloud
    od expanded to g, and the surface rows (``_surf``)."""
    return (_tb(taut_t), _tb(fracs_t), _tb(planklay_t), _tb(planklev_t),
            _tb(taucb_t)[..., ngb0.long()], *_surf(surf))


def rt_sweep_banded(taut_t, fracs_t, planklay_t, planklev_t, surf, cldf_t,
                    taucb_t, ngb0, wg, radiances=False, luts=None,
                    weighted=False):
    """Fluxes (4|6, L+1, B) under random overlap of per-band clouds
    (icld=1): the plain version of the RT kernel's banded mode.
    cldf_t (L, B) the cloud fraction, taucb_t (L, 16, B) the cloud od
    per band (``cldprop.cldprop_banded_blocked``); a layer is cloudy
    where cldf >= CLOUD_GATE, for every g.  surf as
    ``rt_sweep_blocked``.  ``radiances``: (the fluxes, rads (4|6, L, 140,
    B)), as ``rt_sweep_blocked``'s with clouds: the plain version of
    ``rtrn_cuda.rt_sweep_g_radiances`` in the banded mode.  ``luts`` as
    ``rt_sweep_blocked``'s; ``weighted``: taucb_t already carries its
    secant (``precompute``'s ``odcld_weighted``), which no kernel takes."""
    taut, fracs, play, plev, odcld_g, secd, semiss, plankbnd, dpl = \
        _band_layouts(taut_t, fracs_t, planklay_t, planklev_t, surf,
                      taucb_t, ngb0)
    B, L, G = taut.shape
    cf = cldf_t.t()
    cloudy = cf >= CLOUD_GATE
    res = _sweep(taut, fracs, play, plev, plankbnd, semiss, secd,
                 cf[..., None].expand(B, L, G), odcld_g, cloudy,
                 cloudy[..., None].expand(B, L, G), ngb0, wg, luts=luts,
                 dplankbnd_dt=dpl, radiances=radiances,
                 odcld_weighted=weighted)
    fluxes, rads = res if radiances else (res, None)
    fluxes = torch.stack(fluxes).permute(0, 2, 1).contiguous()
    return (fluxes, rads.contiguous()) if radiances else fluxes


def rt_sweep_banded_vjp(taut_t, fracs_t, planklay_t, planklev_t, surf,
                        cldf_t, taucb_t, ngb0, wg, ct, needs=(True,) * 7):
    """ct (4|6, L+1, B) -> cotangents of (taut_t, fracs_t, planklay_t,
    planklev_t, surf, cldf_t, taucb_t), None where ``needs`` is False:
    the plain version of ``rtrn_cuda.rt_sweep_banded_vjp``."""
    return plain_vjp(lambda *x: rt_sweep_banded(*x, ngb0, wg),
                     (taut_t, fracs_t, planklay_t, planklev_t, surf, cldf_t,
                      taucb_t), needs, (ct,))


def substreams_kept(rows_t):
    """(2, L, B) bool: where the maxrand state keeps the sub-streams
    entering layer l, in the down sweep then the up sweep: in a cloudy
    layer that does not restart them, the only places the adjoint reads
    them.  rows_t (L, 16, B) the overlap rows."""
    cloudy = rows_t[:, ROW_CLDF] >= CLOUD_GATE
    restart = rows_t[:, [ROW_IST_DN, ROW_IST_UP]] > 0.0
    return (cloudy[:, None] & ~restart).transpose(0, 1)


def substream_slots(rows_t):
    """-> (slots (2, L, B), counts (2, B)), int64: the packed maxrand
    state's slot of the sub-streams entering layer l in the down sweep
    then the up sweep, the count of the column's kept layers
    (``substreams_kept``) before l in that sweep's order (down: from the
    top layer; up: from the surface), and each column's count of kept
    layers in each sweep."""
    kept = substreams_kept(rows_t).long()
    down = kept[0].flip(0).cumsum(0).flip(0) - kept[0]
    up = kept[1].cumsum(0) - kept[1]
    return torch.stack([down, up]), kept.sum(dim=1)


def kept_depth(counts):
    """K, the slots a sweep of the packed maxrand state: the most kept
    layers of any column in either sweep (``substream_slots``' counts),
    at least 1."""
    return max(1, int(counts.max()))


def _kept_index(rows_t):
    """[(sweep, layers, columns, slots)] of every kept (layer, column)."""
    slots, _ = substream_slots(rows_t)
    out = []
    for s, keep in enumerate(substreams_kept(rows_t)):
        l, b = keep.nonzero(as_tuple=True)
        out.append((s, l, b, slots[s, l, b]))
    return out


def pack_state(state, rows_t):
    """The (10 | 12, L, 140, B) maxrand state (radiances, then the
    sub-streams of each sweep at every layer, then at idrv=1 the d/dT
    derivatives) -> (rads (4 | 6, L, 140, B): the radiances and the
    derivatives, subs (2, 3, K, 140, B)): the sub-streams of the kept
    layers only, at their slots (``substream_slots``; K from
    ``kept_depth``), zeros past a column's count."""
    _, L, G, B = state.shape
    full = state[4:10].reshape(2, 3, L, G, B)
    subs = state.new_zeros((2, 3, kept_depth(substream_slots(rows_t)[1]), G,
                            B))
    for s, l, b, k in _kept_index(rows_t):
        subs[s][:, k, :, b] = full[s][:, l, :, b]
    return torch.cat([state[:4], state[10:]]), subs


def unpack_state(rads, subs, rows_t):
    """The maxrand state as K1 keeps it, rads (4 | 6, L, 140, B) and the
    packed sub-streams subs (2, 3, K, 140, B), -> (10 | 12, L, 140, B):
    the radiances, then the sub-streams entering each layer in the down
    sweep and in the up sweep, zero where they are not kept
    (``substreams_kept``), then (idrv=1) the d/dT derivatives.  What
    compares two states: the slots past a column's count hold nothing."""
    _, L, G, B = rads.shape
    full = subs.new_zeros((2, 3, L, G, B))
    for s, l, b, k in _kept_index(rows_t):
        full[s][:, l, :, b] = subs[s][:, k, :, b]
    return torch.cat([rads[:4], full.view(6, L, G, B), rads[4:]])


def rt_sweep_maxrand(taut_t, fracs_t, planklay_t, planklev_t, surf, rows_t,
                     taucb_t, ngb0, wg, radiances=False, luts=None,
                     weighted=False):
    """Fluxes (4|6, L+1, B) under maximum-random overlap (icld 2/3):
    the plain version of the RT kernel's maxrand mode.  rows_t
    (L, 16, B) from ``rtrnmr.overlap_rows``, taucb_t and surf as
    ``rt_sweep_banded``.  ``radiances``: (the fluxes, rads, subs), the
    state K6 reads: rads (4 | 6, L, 140, B) the down radiance at level l,
    the up radiance entering layer l and their clear twins, at idrv=1 then
    the d/dT derivative entering layer l and its clear twin; subs (2, 3, K,
    140, B) the sub-streams (cr, kr, rr) entering a layer in the down
    sweep and in the up sweep where they are kept, packed
    (``pack_state``); the plain version of
    ``rtrn_cuda.rt_sweep_maxrand_radiances``.  ``luts``, ``weighted``:
    as ``rt_sweep_banded``'s."""
    taut, fracs, play, plev, odcld_g, secd, semiss, plankbnd, dpl = \
        _band_layouts(taut_t, fracs_t, planklay_t, planklev_t, surf,
                      taucb_t, ngb0)
    res = _sweep_maxrand(taut, fracs, play, plev, plankbnd, semiss, secd,
                         _tb(rows_t), odcld_g, ngb0, wg, dplankbnd_dt=dpl,
                         radiances=radiances, luts=luts,
                         odcld_weighted=weighted)
    fluxes, rads = res if radiances else (res, None)
    fluxes = torch.stack(fluxes).permute(0, 2, 1).contiguous()
    if not radiances:
        return fluxes
    return (fluxes, *pack_state(rads.contiguous(), rows_t))


def rt_sweep_maxrand_vjp(taut_t, fracs_t, planklay_t, planklev_t, surf,
                         rows_t, taucb_t, ngb0, wg, ct, needs=(True,) * 7):
    """ct (4|6, L+1, B) -> cotangents of (taut_t, fracs_t, planklay_t,
    planklev_t, surf, rows_t, taucb_t), None where ``needs`` is False:
    the plain version of ``rtrn_cuda.rt_sweep_maxrand_vjp``."""
    return plain_vjp(lambda *x: rt_sweep_maxrand(*x, ngb0, wg),
                     (taut_t, fracs_t, planklay_t, planklev_t, surf, rows_t,
                      taucb_t), needs, (ct,))


def _sweep_g(taut_t, fracs_t, planklay_t, planklev_t, surf, *rest):
    """``rt_sweep_blocked`` with the per-g cloud fields spread out before
    ngb0 and wg."""
    *fields, ngb0, wg = rest
    return rt_sweep_blocked(taut_t, fracs_t, planklay_t, planklev_t, surf,
                            ngb0, wg, tuple(fields))


def rt_sweep_g_vjp(taut_t, fracs_t, planklay_t, planklev_t, surf, fields,
                   ngb0, wg, ct, needs=None):
    """ct (4|6, L+1, B) -> cotangents of (taut_t, fracs_t, planklay_t,
    planklev_t, surf, *fields), None where ``needs`` (default all) is
    False; ``fields`` the per-g cloud fields of ``rt_sweep_blocked``'s
    fused (6) or cldf-odcld (2) mode, whose pad rows 140-143 get zero:
    the plain version of ``rtrn_cuda.rt_sweep_g_vjp``."""
    xs = (taut_t, fracs_t, planklay_t, planklev_t, surf, *fields)
    return plain_vjp(lambda *x: _sweep_g(*x, ngb0, wg), xs,
                     (True,) * len(xs) if needs is None else needs, (ct,))


# the plain versions of K1's modes behind ``rtrn_cuda.RTSweepFn``:
# (taut_t, fracs_t, planklay_t, planklev_t, surf, *clouds, ngb0, wg)
SWEEPS = {"banded": rt_sweep_banded, "maxrand": rt_sweep_maxrand,
          "fused": _sweep_g, "cldf_od": _sweep_g}


def rt_sweep_vjp(taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t,
                 abl_t, mask, ngb0, wg, ct, needs=(True,) * 8):
    """ct (4, L+1, B) -> cotangents of (taut_t, fracs_t, planklay_t,
    planklev_t, surf, cw_t, abi_t, abl_t), None where ``needs`` is False
    or the input is None (clear sky): the plain version of
    ``rtrn_cuda.rt_sweep_vjp``."""
    def fn(*x):
        cf = None if mask is None else (mask, *x[5:])
        return rt_sweep_blocked(*x[:5], ngb0, wg, cf)
    xs = (taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t, abl_t)
    return plain_vjp(fn, xs, [n and x is not None for n, x in zip(needs, xs)],
                     (ct,))


def _ddt_factors(mode, taut_t, fracs_t, planklay_t, planklev_t, surf,
                 clouds, ngb0):
    """``ddt_adjoint``'s at, atot, cf, cly, anyc and d0 as the sweep of K1
    ``mode`` (a ``rtrn_cuda.MODES`` key) forms them from its inputs;
    clouds as ``rt_sweep_ddt_vjp``'s."""
    ngb0 = ngb0.long()
    taut, fracs, play, plev = (_tb(x) for x in (taut_t, fracs_t, planklay_t,
                                                planklev_t))
    B, L, G = taut.shape
    secd, _, _, dpl = _surf(surf)
    if mode in ("banded", "maxrand"):
        odcld_g = _tb(clouds[1])[..., ngb0]
        rows = _tb(clouds[0]) if mode == "maxrand" else None
        cf = clouds[0].t() if rows is None else rows[..., ROW_CLDF]
        cloudy = cf >= CLOUD_GATE
        cf_g, gate = (x[..., None].expand(B, L, G) for x in (cf, cloudy))
        cly = cloudy[..., None]
        anyc = (cloudy.any(1, keepdim=True) if rows is None
                else rows[:, :1, ROW_ICLDDN] > 0.0)
    else:
        cf_g, odcld_g, gate = _g_clouds(tuple(clouds) or None, taut, ngb0)
        cly = gate.any(-1, keepdim=True)
        anyc = cly[..., 0].any(1, keepdim=True)
    pre = precompute(taut, cf_g, odcld_g, gate, fracs, play, plev, secd,
                     ngb0)
    return (pre["atrans"], pre["atot"], cf_g, cly, anyc,
            fracs[:, 0, :] * dpl[:, ngb0])


def rt_sweep_ddt_vjp(mode, taut_t, fracs_t, planklay_t, planklev_t, surf,
                     clouds, ngb0, wg, ct_ddt, rads=None):
    """The plain twin of K6's d/dT part at idrv=1: ct_ddt (2, L+1, B), the
    cotangents of duflx_dt and duflxc_dt -> cotangents of (taut_t,
    fracs_t, planklay_t, planklev_t, surf (4, 16, B), *clouds), zeros
    where the d/dT outputs do not read an input (None for the compact
    mask), for the sweep of K1 ``mode`` (a ``rtrn_cuda.MODES`` key),
    clouds: clear (), compact ``rt_sweep_blocked``'s (mask, cw, abi,
    abl), the others ``rtrn_cuda.CLOUD_INPUTS[mode]``.  ``ddt_adjoint``
    gives the cotangents of each layer's factors and of the surface seed,
    and autograd of the factors as the sweep forms them
    (``_ddt_factors``) carries them to the inputs, as K6's reverse steps
    do; equal to the plain vjp of the sweep on the cotangent (0, 0, 0, 0,
    *ct_ddt) up to the order of the sums.  ``rads``: the (6, L, 140, B)
    radiances the sweep kept at idrv=1 in a cloudy mode
    (``rt_sweep_blocked``, ``rt_sweep_banded`` or ``rt_sweep_maxrand`` with
    ``radiances=True``), whose planes 4-5, the derivatives entering each
    layer, ``ddt_adjoint`` reads (``saved``) as K6 does in those modes."""
    saved = None if rads is None else tuple(_tb(r) for r in rads[4:6])
    xs = [x.detach().requires_grad_(x.is_floating_point())
          for x in (taut_t, fracs_t, planklay_t, planklev_t, surf, *clouds)]
    with torch.enable_grad():
        at, atot, cf, cly, anyc, d0 = _ddt_factors(mode, *xs[:5], xs[5:],
                                                   ngb0)
        cts = ddt_adjoint(at.detach(), atot.detach(), cf.detach(), cly, anyc,
                          d0.detach(), wg, ct_ddt, saved)
        outs = [(o, c) for o, c in zip((at, atot, cf, d0), cts)
                if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in outs],
                                    [x for x in xs if x.requires_grad],
                                    [c for _, c in outs], allow_unused=True)
    grads = iter(grads)
    out = []
    for x in xs:
        g = next(grads) if x.requires_grad else None
        out.append(torch.zeros_like(x) if g is None and x.requires_grad
                   else g)
    return tuple(out)


def split_ddt(out):
    """(4|6, L+1, B) -> the fluxes (4, L+1, B), or (fluxes, d/dT rows
    (2, L+1, B)) when idrv=1: the return of every ``rt_fluxes_*``."""
    return out if out.shape[0] == 4 else (out[:4], out[4:])


def rt_fluxes_blocked(taut_t, fracs_t, planklay_t, planklev_t, plankbnd,
                      semiss, pwvcm, ngb0, wg, cloud_fields=None,
                      dplankbnd_dt=None, taua_t=None, luts=None):
    """``rt_sweep_blocked`` with the surface rows formed from plankbnd,
    semiss, dplankbnd_dt (B, 16; None for idrv=0) and pwvcm (B,), split
    by ``split_ddt``: the plain version of ``rtrn_cuda.rt_fluxes_blocked``
    (and of ``rt_fluxes_fused`` / ``rt_fluxes_cldf_od``, whose cloud
    fields select those modes).  ``luts``: the table factors
    (``use_lut=True``), the route of the model's LUT steps on either
    impl."""
    return split_ddt(rt_sweep_blocked(
        *spec_inputs(taut_t, fracs_t, taua_t, ngb0), planklay_t, planklev_t,
        surf_rows(plankbnd, semiss, pwvcm, planklay_t.dtype, dplankbnd_dt),
        ngb0, wg, cloud_fields, luts=luts))


def rt_fluxes_banded(taut_t, fracs_t, planklay_t, planklev_t, plankbnd,
                     semiss, pwvcm, ngb0, wg, cldf_t, taucb_t,
                     dplankbnd_dt=None, taua_t=None, luts=None,
                     weighted=False):
    """``rt_sweep_banded`` with the surface rows formed as in
    ``rt_fluxes_blocked``: the plain version of
    ``rtrn_cuda.rt_fluxes_banded``."""
    return split_ddt(rt_sweep_banded(
        *spec_inputs(taut_t, fracs_t, taua_t, ngb0), planklay_t, planklev_t,
        surf_rows(plankbnd, semiss, pwvcm, planklay_t.dtype, dplankbnd_dt),
        cldf_t, taucb_t, ngb0, wg, luts=luts, weighted=weighted))


def rt_fluxes_maxrand(taut_t, fracs_t, planklay_t, planklev_t, plankbnd,
                      semiss, pwvcm, ngb0, wg, rows_t, taucb_t,
                      dplankbnd_dt=None, taua_t=None, luts=None,
                      weighted=False):
    """``rt_sweep_maxrand`` with the surface rows formed as in
    ``rt_fluxes_blocked``: the plain version of
    ``rtrn_cuda.rt_fluxes_maxrand``."""
    return split_ddt(rt_sweep_maxrand(
        *spec_inputs(taut_t, fracs_t, taua_t, ngb0), planklay_t, planklev_t,
        surf_rows(plankbnd, semiss, pwvcm, planklay_t.dtype, dplankbnd_dt),
        rows_t, taucb_t, ngb0, wg, luts=luts, weighted=weighted))


# the model's RT step per K1 mode, plain versions (``rtrn_cuda.WRAPPERS``
# holds the kernels'); rt_fluxes_blocked's cloud fields select its mode
FLUXES = {"blocked": rt_fluxes_blocked, "fused": rt_fluxes_blocked,
          "cldf_od": rt_fluxes_blocked, "banded": rt_fluxes_banded,
          "maxrand": rt_fluxes_maxrand}
