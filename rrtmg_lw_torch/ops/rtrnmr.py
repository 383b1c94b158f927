"""Maximum-random cloud overlap: the per-column overlap factors.

Port of ``rrtmg_lw_tpu.ops.rtrnmr`` (rrtmg_lw_rtrnmr.f90:51-806).  Two
per-column passes compute the clear/cloud transfer factors between
adjacent layers in each sweep direction (:347-428 up, :430-506 down),
carrying the (rat1, rat2) state across contiguous cloudy blocks; the
radiance recursion (``rtrn._sweep_maxrand``) then tracks cloudy and
clear sub-streams that exchange a correction radiance.

As in the JAX package, factors the reference leaves uninitialized on
paths where they are never read are zero, and every division goes
through ``_safe_div`` so that unselected lanes cannot produce NaN.

``overlap_rows`` is the plain version of the overlap kernel
(``ops.rtrnmr_cuda.overlap_rows``): a Python loop over layers on (B,)
tensors, whose elementwise order the kernel repeats; its autograd vjp is
the plain version of the adjoint kernel (``rtrnmr_cuda.overlap_rows_vjp``).
"""

from __future__ import annotations

import torch

from . import rtrn


def _safe_div(a, b):
    return a / torch.where(b == 0.0, 1.0, b)


def _overlap_step(c, nxt, prv, ist, live, rat1, rat2):
    """One layer of either pass: ``nxt`` is the cloud fraction of the
    layer the sweep goes to, ``prv`` of the one it comes from.  Returns
    the six factors (facclr1, facclr2, faccld1, faccld2, faccmb1,
    faccmb2), zero where not ``live``, and the new (rat1, rat2)."""
    zero = torch.zeros_like(c)
    inc = nxt >= c

    fmax = torch.maximum(c, prv)
    clr2_ist = torch.where(c < 1.0, _safe_div(nxt - c, 1.0 - c), zero)
    clr1_e = torch.where(nxt < fmax, _safe_div(nxt - c, prv - c), rat2)
    clr2_e = torch.where(nxt > fmax, _safe_div(nxt - fmax, 1.0 - fmax), zero)
    facclr1 = torch.where(ist, zero, clr1_e)
    facclr2 = torch.where(ist, clr2_ist, clr2_e)

    fmin = torch.minimum(c, prv)
    cld2_ist = _safe_div(c - nxt, c)
    le = nxt <= fmin
    cld1_e = torch.where(le, rat1, _safe_div(c - nxt, c - fmin))
    cld2_e = torch.where(le, _safe_div(fmin - nxt, fmin), zero)
    faccld1 = torch.where(ist, zero, cld1_e)
    faccld2 = torch.where(ist, cld2_ist, cld2_e)

    facclr1 = torch.where(inc, facclr1, zero)
    facclr2 = torch.where(inc, facclr2, zero)
    faccld1 = torch.where(inc, zero, faccld1)
    faccld2 = torch.where(inc, zero, faccld2)

    # maximum, not clamp_min: at a tie (0 against 0) it passes half the
    # gradient, as jnp.maximum does in the JAX package
    faccmb1 = torch.where(ist, zero, torch.maximum(
        torch.minimum(nxt - c, prv - c), zero))
    faccmb2 = torch.where(ist, zero, torch.maximum(
        torch.minimum(c - nxt, c - prv), zero))

    facs = tuple(torch.where(live, v, zero) for v in
                 (facclr1, facclr2, faccld1, faccld2, faccmb1, faccmb2))
    anyclr = (facclr1 > 0.0) | (facclr2 > 0.0)
    anycld = (faccld1 > 0.0) | (faccld2 > 0.0)
    one = torch.ones_like(c)
    rat1 = torch.where(live, torch.where(inc & anyclr, one, zero), rat1)
    rat2 = torch.where(live, torch.where(~inc & anycld, one, zero), rat2)
    return facs, rat1, rat2


def _overlap_pass(cldfrac, cloudy, up):
    """The six factors (B, L) of the up (``up``) or down pass, entry
    [l] the factors the radiance recursion uses at layer l, and the
    stream-restart flag istcld / istcldd (B, L)."""
    B, L = cldfrac.shape
    zero = cldfrac.new_zeros(B)
    true = torch.ones(B, dtype=torch.bool, device=cldfrac.device)
    rat1 = rat2 = zero
    facs = [[None] * L for _ in range(6)]
    ists = [None] * L
    for l in (range(L) if up else range(L - 1, -1, -1)):
        below = cldfrac[:, l - 1] if l > 0 else zero
        above = cldfrac[:, l + 1] if l < L - 1 else zero
        if up:      # restart above a clear layer; the top layer is dead
            ist = ~cloudy[:, l - 1] if l > 0 else true
            live = cloudy[:, l] & (l < L - 1)
            nxt, prv = above, below
        else:       # restart below a clear layer; the bottom is dead
            ist = ~cloudy[:, l + 1] if l < L - 1 else true
            live = cloudy[:, l] & (l > 0)
            nxt, prv = below, above
        out, rat1, rat2 = _overlap_step(cldfrac[:, l], nxt, prv, ist, live,
                                        rat1, rat2)
        for i, f in enumerate(out):
            facs[i][l] = f
        ists[l] = ist
    return ([torch.stack(f, dim=1) for f in facs],
            torch.stack(ists, dim=1))


def overlap_factors_up(cldfrac, cloudy):
    """Up-sweep factors, 6 x (B, L), and istcld (B, L);
    rrtmg_lw_rtrnmr.f90:347-428."""
    return _overlap_pass(cldfrac, cloudy, up=True)


def overlap_factors_down(cldfrac, cloudy):
    """Down-sweep factors, 6 x (B, L), and istcldd (B, L);
    rrtmg_lw_rtrnmr.f90:430-506."""
    return _overlap_pass(cldfrac, cloudy, up=False)


def overlap_rows(cldfrac):
    """(B, L) cloud fraction -> the (L, 16, B) rows K1's maxrand mode
    reads per layer: cldfrac, istcld, istcldd, iclddn (cloud in this
    layer or above), the 6 down factors, the 6 up factors."""
    cloudy = cldfrac >= rtrn.CLOUD_GATE
    up, istcld = overlap_factors_up(cldfrac, cloudy)
    dn, istcldd = overlap_factors_down(cldfrac, cloudy)
    iclddn = torch.flip(torch.cumsum(torch.flip(cloudy.int(), [1]), 1),
                        [1]) > 0
    dt = cldfrac.dtype
    rows = [cldfrac, istcld.to(dt), istcldd.to(dt), iclddn.to(dt), *dn, *up]
    return torch.stack([r.t() for r in rows], dim=1).contiguous()


def rt_maxrandom(taut, fracs, planklay, planklev, plankbnd, semiss, pwvcm,
                 pz, cldfrac, odcld_g, *, static, heatfac_val, luts=None,
                 use_lut=False, idrv=0, dplankbnd_dt=None, istart=1,
                 iend=16, odcld_weighted=False):
    """Maximum-random overlap RT (rtrnmr.f90) over the g-points of bands
    istart..iend, in the (B, L, G) layout: cldfrac (B, L) per layer,
    odcld_g (B, L, G) the per-band cloud od expanded by band of g
    (``odcld_weighted`` when it already carries its secant).
    ``use_lut``: the table factors from ``luts``.  idrv=1 also gives
    d(up)/dT_sfc from ``dplankbnd_dt`` (B, 16)."""
    gsel = rtrn.g_select(static, istart, iend)
    ngb0, wg = (x[gsel] for x in rtrn.g_tables(static, taut.device,
                                                taut.dtype))
    rows = overlap_rows(cldfrac).permute(2, 0, 1)      # (B, L, 16)
    return rtrn.rt_out(rtrn._sweep_maxrand(
        taut, fracs, planklay, planklev, plankbnd, semiss,
        rtrn.secdiff(pwvcm, taut.dtype), rows, odcld_g, ngb0, wg,
        dplankbnd_dt if idrv else None, luts=luts if use_lut else None,
        odcld_weighted=odcld_weighted), pz, heatfac_val)
