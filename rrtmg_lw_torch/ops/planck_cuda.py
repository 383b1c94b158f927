"""Planck-table interpolation kernel (K3), csrc/planck.cu.

Replaces ``rrtmg_lw_tpu/ops/planck_pallas.py::_build.kernel``.  On a
CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain version, ``setcoef.interp_planck_blocked``.
"""

from __future__ import annotations

import torch

from .. import _build
from .setcoef import interp_planck_blocked


def planck_interp_blocked(temp_t: torch.Tensor, totplnk: torch.Tensor):
    """(N, B) temperatures -> (N, 16, B) Planck sources, interpolated in
    totplnk (181, 16) at ind = clamp(int(T - 159), 1, 180)."""
    if temp_t.device.type == "cpu":
        return interp_planck_blocked(temp_t, totplnk)
    N, B = temp_t.shape
    _build.check(temp_t, "temp_t", torch.float32, (N, B), temp_t.device)
    _build.check(totplnk, "totplnk", torch.float32, (181, 16), temp_t.device)
    out = torch.empty((N, 16, B), dtype=torch.float32, device=temp_t.device)
    _build.launch("rrtm_planck", temp_t, totplnk, out, N, B)
    planck_interp_blocked.launches += 1
    return out


planck_interp_blocked.launches = 0
