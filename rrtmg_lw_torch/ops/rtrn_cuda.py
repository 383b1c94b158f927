"""Radiative-transfer sweep kernel (K1), csrc/rtrn.cu, and its adjoint
(K6), csrc/rtrn_bwd.cu.

K1 replaces ``rrtmg_lw_tpu/ops/rtrn_pallas.py::_build_kernel.kernel``
in its clear, compact-cloud, banded (icld=1) and maxrand (icld 2/3)
modes (idrv=0); K6 replaces the JAX package's unrolled XLA backward of
it (``ops/rtrn_bwd.py:259`` ``rt_bwd_fluxes``) in the clear and compact
modes.  ``RTFn`` pairs them for autograd; ``RTBandFn`` holds the banded
and maxrand modes, whose adjoint is not ported: on the card their
backward raises.  On a CUDA tensor each wrapper launches its kernel (or
raises); on a CPU tensor it runs the plain version
(``rtrn.rt_sweep_blocked``, ``rtrn.rt_sweep_vjp``,
``rtrn.rt_sweep_banded``, ``rtrn.rt_sweep_maxrand``) and, backward, its
plain vjp.
"""

from __future__ import annotations

import torch

from .. import _build
from ..types import NGPT, NGPT_PAD
from . import rtrn
from ._autograd import plain_vjp

# the kernel's mode argument (csrc/rtrn.cuh enum Mode)
MODES = {"clear": 0, "compact": 1, "banded": 2, "maxrand": 3}


def _check(taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t, abl_t,
           mask, ngb0, wg):
    L, _, B = taut_t.shape
    dev = taut_t.device
    f32 = torch.float32
    _build.check(taut_t, "taut_t", f32, (L, NGPT, B), dev)
    _build.check(fracs_t, "fracs_t", f32, (L, NGPT, B), dev)
    _build.check(planklay_t, "planklay_t", f32, (L, 16, B), dev)
    _build.check(planklev_t, "planklev_t", f32, (L + 1, 16, B), dev)
    _build.check(surf, "surf", f32, (3, 16, B), dev)
    _build.check(ngb0, "ngb0", torch.int32, (NGPT,), dev)
    _build.check(wg, "wg", f32, (NGPT,), dev)
    if mask is not None:
        _build.check(mask, "mask", torch.int8, (L, NGPT_PAD, B), dev)
        _build.check(cw_t, "cw_t", f32, (L, 2, B), dev)
        _build.check(abi_t, "abi_t", f32, (L, 16, B), dev)
        _build.check(abl_t, "abl_t", f32, (L, 16, B), dev)
    return L, B


class RTFn(torch.autograd.Function):
    """(taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t,
    abl_t, mask, ngb0, wg) -> fluxes (4, L+1, B); the four cloud inputs
    are None for clear sky.  Backward K6; mask, ngb0 and wg get None."""

    @staticmethod
    def forward(ctx, taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t,
                abi_t, abl_t, mask, ngb0, wg):
        args = (taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t,
                abl_t, mask, ngb0, wg)
        if any(ctx.needs_input_grad[:8]):
            ctx.save_for_backward(*args)
        if taut_t.device.type == "cpu":
            cf = None if mask is None else (mask, cw_t, abi_t, abl_t)
            return rtrn.rt_sweep_blocked(taut_t, fracs_t, planklay_t,
                                         planklev_t, surf, ngb0, wg, cf)
        L, B = _check(*args)
        out = torch.empty((4, L + 1, B), dtype=torch.float32,
                          device=taut_t.device)
        _build.launch("rrtm_rt", taut_t, fracs_t, planklay_t, planklev_t,
                      surf, ngb0, wg, mask, cw_t, abi_t, abl_t, None, None,
                      out, L, B, MODES["clear" if mask is None else "compact"])
        rt_fluxes_blocked.launches += 1
        return out

    @staticmethod
    def backward(ctx, ct):
        grads = rt_sweep_vjp(*ctx.saved_tensors, ct.contiguous(),
                             needs=ctx.needs_input_grad[:8])
        return (*grads, None, None, None)


def rt_fluxes_blocked(taut_t, fracs_t, planklay_t, planklev_t, plankbnd,
                      semiss, pwvcm, ngb0, wg, cloud_fields=None):
    """Band-integrated fluxes (4, L+1, B) = [up, down, clear up, clear
    down]; arguments as ``rtrn.rt_fluxes_blocked`` (the compact mask
    must be int8 here).  The surface rows are formed outside ``RTFn``,
    so autograd differentiates the diffusivity secant."""
    surf = rtrn.surf_rows(plankbnd, semiss, pwvcm, taut_t.dtype)
    cw_t = abi_t = abl_t = mask = None
    if cloud_fields is not None:
        mask, cw_t, abi_t, abl_t = cloud_fields
    return RTFn.apply(taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t,
                      abi_t, abl_t, mask, ngb0, wg)


class RTBandFn(torch.autograd.Function):
    """(mode, taut_t, fracs_t, planklay_t, planklev_t, surf, cld, taucb_t,
    ngb0, wg) -> fluxes (4, L+1, B), K1 in the banded mode (cld: cloud
    fraction (L, B)) or the maxrand mode (cld: overlap rows (L, 16, B)).
    Backward: the plain vjp on the CPU; on the card it raises."""

    @staticmethod
    def forward(ctx, mode, taut_t, fracs_t, planklay_t, planklev_t, surf,
                cld, taucb_t, ngb0, wg):
        ctx.mode, ctx.device_type = mode, taut_t.device.type
        args = (taut_t, fracs_t, planklay_t, planklev_t, surf, cld, taucb_t,
                ngb0, wg)
        if taut_t.device.type == "cpu":
            # the plain vjp reads them; on the card backward only raises
            if any(ctx.needs_input_grad[1:8]):
                ctx.save_for_backward(*args)
            return rtrn.SWEEPS[mode](*args)
        L, B = _check(*args[:5], None, None, None, None, ngb0, wg)
        dev = taut_t.device
        rows = (L, B) if mode == "banded" else (L, rtrn.NROWS, B)
        _build.check(cld, "cldf_t" if mode == "banded" else "rows_t",
                     torch.float32, rows, dev)
        _build.check(taucb_t, "taucb_t", torch.float32, (L, 16, B), dev)
        out = torch.empty((4, L + 1, B), dtype=torch.float32, device=dev)
        _build.launch("rrtm_rt", taut_t, fracs_t, planklay_t, planklev_t,
                      surf, ngb0, wg, None, None, None, None, cld, taucb_t,
                      out, L, B, MODES[mode])
        BAND_WRAPPERS[mode].launches += 1
        return out

    @staticmethod
    def backward(ctx, ct):
        if ctx.device_type != "cpu":
            raise NotImplementedError(
                f"gradients through the {ctx.mode} RT sweep (deterministic "
                "clouds, imca=0) on the card: its adjoint kernel is not "
                "ported yet; see ROADMAP.md Queue 1 item 9")
        x = ctx.saved_tensors
        ngb0, wg = x[7:]
        grads = plain_vjp(lambda *a: rtrn.SWEEPS[ctx.mode](*a, ngb0, wg),
                          x[:7], ctx.needs_input_grad[1:8], (ct,))
        return (None, *grads, None, None)


def rt_fluxes_banded(taut_t, fracs_t, planklay_t, planklev_t, plankbnd,
                     semiss, pwvcm, ngb0, wg, cldf_t, taucb_t):
    """K1 banded mode: fluxes (4, L+1, B) under random overlap of
    per-band clouds; arguments as ``rtrn.rt_fluxes_banded``."""
    surf = rtrn.surf_rows(plankbnd, semiss, pwvcm, taut_t.dtype)
    return RTBandFn.apply("banded", taut_t, fracs_t, planklay_t, planklev_t,
                          surf, cldf_t, taucb_t, ngb0, wg)


def rt_fluxes_maxrand(taut_t, fracs_t, planklay_t, planklev_t, plankbnd,
                      semiss, pwvcm, ngb0, wg, rows_t, taucb_t):
    """K1 maxrand mode: fluxes (4, L+1, B) under maximum-random overlap;
    arguments as ``rtrn.rt_fluxes_maxrand``."""
    surf = rtrn.surf_rows(plankbnd, semiss, pwvcm, taut_t.dtype)
    return RTBandFn.apply("maxrand", taut_t, fracs_t, planklay_t,
                          planklev_t, surf, rows_t, taucb_t, ngb0, wg)


BAND_WRAPPERS = {"banded": rt_fluxes_banded, "maxrand": rt_fluxes_maxrand}


def rt_sweep_vjp(taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t,
                 abl_t, mask, ngb0, wg, ct, needs=(True,) * 8):
    """K6: flux cotangents ct (4, L+1, B) -> cotangents of (taut_t,
    fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t, abl_t), None
    where ``needs`` is False or the input is None (clear sky)."""
    if taut_t.device.type == "cpu":
        return rtrn.rt_sweep_vjp(taut_t, fracs_t, planklay_t, planklev_t,
                                 surf, cw_t, abi_t, abl_t, mask, ngb0, wg,
                                 ct, needs)
    L, B = _check(taut_t, fracs_t, planklay_t, planklev_t, surf, cw_t, abi_t,
                  abl_t, mask, ngb0, wg)
    dev = taut_t.device
    _build.check(ct, "ct", torch.float32, (4, L + 1, B), dev)
    cloudy = mask is not None
    grads = [torch.empty_like(x) for x in (taut_t, fracs_t, planklay_t,
                                           planklev_t, surf)]
    grads += [torch.empty_like(x) if cloudy else None
              for x in (cw_t, abi_t, abl_t)]
    # the forward sweeps' radiances, re-read in reverse level order:
    # down and up (and their clear twins when cloudy), (L, 140, B) each
    scratch = torch.empty((4 if cloudy else 2, L, NGPT, B),
                          dtype=torch.float32, device=dev)
    _build.launch("rrtm_rt_bwd", taut_t, fracs_t, planklay_t, planklev_t,
                  surf, ngb0, wg, mask, cw_t, abi_t, abl_t, ct, *grads,
                  scratch, L, B, int(cloudy))
    rt_sweep_vjp.launches += 1
    return tuple(g if n else None for g, n in zip(grads, needs))


rt_fluxes_blocked.launches = 0
rt_fluxes_banded.launches = 0
rt_fluxes_maxrand.launches = 0
rt_sweep_vjp.launches = 0
