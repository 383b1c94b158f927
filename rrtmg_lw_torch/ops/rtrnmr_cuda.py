"""Overlap-rows kernel, csrc/overlap.cu: the per-column pre-pass of K1's
maxrand mode.

The JAX package computes these rows in XLA (``rtrnmr._overlap_factors_up``
/ ``_overlap_factors_down``, two ``lax.scan`` over layers, stacked in
``rrtmg_lw_tpu/ops/rtrn_pallas.py::rt_maxrandom_pallas.rows16``).  In
PyTorch the same scans are a Python loop of ~45 small launches per layer
and pass, so the pre-pass runs as one kernel: one thread per column,
sequential over layers both ways.  On a CUDA tensor ``overlap_rows``
launches it (or raises); on a CPU tensor it runs the plain version,
``rtrnmr.overlap_rows``, and its backward the plain vjp.
"""

from __future__ import annotations

import torch

from .. import _build
from . import rtrn, rtrnmr
from ._autograd import plain_vjp


class OverlapFn(torch.autograd.Function):
    """cldfrac (B, L) -> overlap rows (L, 16, B).  Backward: the plain
    vjp on the CPU; on the card it raises."""

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
        if cldfrac.device.type != "cpu":
            raise NotImplementedError(
                "gradients with respect to the cloud fraction through the "
                "overlap-rows kernel are not ported yet; see ROADMAP.md "
                "Queue 1, gradients through the other forward paths on the "
                "card")
        return plain_vjp(rtrnmr.overlap_rows, (cldfrac,), (True,), (ct,))


def overlap_rows(cldfrac):
    """(B, L) cloud fraction -> (L, 16, B) overlap rows (the layout of
    ``rtrnmr.overlap_rows``)."""
    return OverlapFn.apply(cldfrac)


overlap_rows.launches = 0
