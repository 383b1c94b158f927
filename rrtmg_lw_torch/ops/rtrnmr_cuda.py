"""Overlap-rows kernel, csrc/overlap.cu: the per-column pre-pass of K1's
maxrand mode, and its adjoint.

The JAX package computes these rows in XLA (``rtrnmr._overlap_factors_up``
/ ``_overlap_factors_down``, two ``lax.scan`` over layers, stacked in
``rrtmg_lw_tpu/ops/rtrn_pallas.py::rt_maxrandom_pallas.rows16``), and
their gradient by XLA autodiff.  In PyTorch the same scans are a Python
loop of ~45 small launches per layer and pass, so the pre-pass runs as
one kernel (a block of 32 columns: the carries of each column and pass
walked in shared memory, then every row written by whole warps), and its
vjp as another (local to each layer: the carries carry no gradient).
On a CUDA tensor ``overlap_rows`` launches the kernel (or raises) and
its backward the adjoint (``overlap_rows_vjp``); on a CPU tensor they
run the plain version, ``rtrnmr.overlap_rows``, and its plain vjp.
"""

from __future__ import annotations

import torch

from .. import _build
from . import rtrn, rtrnmr
from ._autograd import plain_vjp


class OverlapFn(torch.autograd.Function):
    """cldfrac (B, L) -> overlap rows (L, 16, B).  Backward: the adjoint
    kernel on the card, the plain vjp on the CPU."""

    @staticmethod
    def forward(ctx, cldfrac):
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(cldfrac)
        if cldfrac.device.type == "cpu":
            return rtrnmr.overlap_rows(cldfrac)
        B, L = cldfrac.shape
        _build.check(cldfrac, "cldfrac", torch.float32, (B, L),
                     cldfrac.device)
        rows = torch.empty((L, rtrn.NROWS, B), dtype=torch.float32,
                           device=cldfrac.device)
        _build.launch("rrtm_overlap", cldfrac, rows, L, B)
        overlap_rows.launches += 1
        return rows

    @staticmethod
    def backward(ctx, ct):
        (cldfrac,) = ctx.saved_tensors
        return overlap_rows_vjp(cldfrac, ct.contiguous())


def overlap_rows(cldfrac):
    """(B, L) cloud fraction -> (L, 16, B) overlap rows (the layout of
    ``rtrnmr.overlap_rows``)."""
    return OverlapFn.apply(cldfrac)


def overlap_rows_vjp(cldfrac, ct):
    """The cotangent ct (L, 16, B) of the overlap rows -> that of the
    cloud fraction (B, L): the adjoint kernel on a CUDA tensor (the flag
    rows 1-3 are not read: they carry no gradient), the plain vjp of
    ``rtrnmr.overlap_rows`` on a CPU tensor."""
    if cldfrac.device.type == "cpu":
        return plain_vjp(rtrnmr.overlap_rows, (cldfrac,), (True,), (ct,))[0]
    B, L = cldfrac.shape
    _build.check(cldfrac, "cldfrac", torch.float32, (B, L), cldfrac.device)
    _build.check(ct, "ct", torch.float32, (L, rtrn.NROWS, B), cldfrac.device)
    out = torch.empty_like(cldfrac)
    _build.launch("rrtm_overlap_bwd", cldfrac, ct, out, L, B)
    overlap_rows_vjp.launches += 1
    return out


overlap_rows.launches = 0
overlap_rows_vjp.launches = 0
