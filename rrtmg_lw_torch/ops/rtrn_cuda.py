"""Radiative-transfer sweep kernel (K1), csrc/rtrn.cu.

Replaces ``rrtmg_lw_tpu/ops/rtrn_pallas.py::_build_kernel.kernel`` in
its clear and compact-cloud modes (idrv=0).  On a CUDA tensor the
wrapper launches the kernel (or raises); on a CPU tensor it runs the
plain version, ``rtrn.rt_fluxes_blocked``.
"""

from __future__ import annotations

import torch

from .. import _build
from ..types import NGPT, NGPT_PAD
from . import rtrn


def rt_fluxes_blocked(taut_t, fracs_t, planklay_t, planklev_t, plankbnd,
                      semiss, pwvcm, ngb0, wg, cloud_fields=None):
    """Band-integrated fluxes (4, L+1, B) = [up, down, clear up, clear
    down]; arguments as ``rtrn.rt_fluxes_blocked`` (the compact mask
    must be int8 here)."""
    if taut_t.device.type == "cpu":
        return rtrn.rt_fluxes_blocked(taut_t, fracs_t, planklay_t,
                                      planklev_t, plankbnd, semiss, pwvcm,
                                      ngb0, wg, cloud_fields)
    L, _, B = taut_t.shape
    dev = taut_t.device
    f32 = torch.float32
    _build.check(taut_t, "taut_t", f32, (L, NGPT, B), dev)
    _build.check(fracs_t, "fracs_t", f32, (L, NGPT, B), dev)
    _build.check(planklay_t, "planklay_t", f32, (L, 16, B), dev)
    _build.check(planklev_t, "planklev_t", f32, (L + 1, 16, B), dev)
    _build.check(ngb0, "ngb0", torch.int32, (NGPT,), dev)
    _build.check(wg, "wg", f32, (NGPT,), dev)
    # per-column surface rows: diffusivity secant, emissivity, Planck
    surf = torch.stack([rtrn.secdiff(pwvcm, f32).t(), semiss.t(),
                        plankbnd.t()]).to(f32).contiguous()   # (3, 16, B)
    mask = cw_t = abi_t = abl_t = None
    if cloud_fields is not None:
        mask, cw_t, abi_t, abl_t = cloud_fields
        _build.check(mask, "mask", torch.int8, (L, NGPT_PAD, B), dev)
        _build.check(cw_t, "cw_t", f32, (L, 2, B), dev)
        _build.check(abi_t, "abi_t", f32, (L, 16, B), dev)
        _build.check(abl_t, "abl_t", f32, (L, 16, B), dev)
    out = torch.empty((4, L + 1, B), dtype=f32, device=dev)
    _build.launch("rrtm_rt", taut_t, fracs_t, planklay_t, planklev_t, surf,
                  ngb0, wg, mask, cw_t, abi_t, abl_t, out, L, B,
                  int(cloud_fields is not None))
    rt_fluxes_blocked.launches += 1
    return out


rt_fluxes_blocked.launches = 0
