"""Planck-table interpolation kernel (K3) and its backward (K3b),
csrc/planck.cu.

K3 replaces ``rrtmg_lw_tpu/ops/planck_pallas.py::_build.kernel``, K3b
the backward of its ``custom_vjp`` (planck_pallas.py:137-159).
``PlanckFn`` pairs them for autograd; the table gets no gradient, as in
JAX, where it is static.  On a CUDA tensor each wrapper launches its
kernel (or raises); on a CPU tensor it runs the plain version,
``setcoef.interp_planck_blocked`` and ``setcoef.interp_planck_vjp``.
"""

from __future__ import annotations

import torch

from .. import _build
from .setcoef import interp_planck_blocked, interp_planck_vjp


def _check(temp_t, totplnk):
    N, B = temp_t.shape
    _build.check(temp_t, "temp_t", torch.float32, (N, B), temp_t.device)
    _build.check(totplnk, "totplnk", torch.float32, (181, 16), temp_t.device)
    return N, B


class PlanckFn(torch.autograd.Function):
    """(N, B) temperatures -> (N, 16, B) Planck sources; backward K3b."""

    @staticmethod
    def forward(ctx, temp_t, totplnk):
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(temp_t, totplnk)
        if temp_t.device.type == "cpu":
            return interp_planck_blocked(temp_t, totplnk)
        N, B = _check(temp_t, totplnk)
        out = torch.empty((N, 16, B), dtype=torch.float32,
                          device=temp_t.device)
        _build.launch("rrtm_planck", temp_t, totplnk, out, N, B)
        planck_interp_blocked.launches += 1
        return out

    @staticmethod
    def backward(ctx, ct):
        temp_t, totplnk = ctx.saved_tensors
        return planck_interp_vjp(temp_t, totplnk, ct.contiguous()), None


def planck_interp_blocked(temp_t: torch.Tensor, totplnk: torch.Tensor):
    """(N, B) temperatures -> (N, 16, B) Planck sources, interpolated in
    totplnk (181, 16) at ind = clamp(int(T - 159), 1, 180)."""
    return PlanckFn.apply(temp_t, totplnk)


def planck_interp_vjp(temp_t, totplnk, ct):
    """K3b: ct (N, 16, B) -> the cotangent of temp_t (N, B)."""
    if temp_t.device.type == "cpu":
        return interp_planck_vjp(temp_t, totplnk, ct)
    N, B = _check(temp_t, totplnk)
    _build.check(ct, "ct", torch.float32, (N, 16, B), temp_t.device)
    ct_t = torch.empty((N, B), dtype=torch.float32, device=temp_t.device)
    _build.launch("rrtm_planck_bwd", temp_t, totplnk, ct, ct_t, N, B)
    planck_interp_vjp.launches += 1
    return ct_t


planck_interp_blocked.launches = 0
planck_interp_vjp.launches = 0
