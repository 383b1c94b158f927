"""K8, csrc/mcica.cu: McICA sub-column sampling on the card.

The JAX package samples sub-columns in XLA (``rrtmg_lw_tpu/ops/mcica.py``
``_native_cdf_blocked``, a ``lax.scan`` up the layers, and the compare
and pad of ``mcica_subcol_lw_compact``); in PyTorch the same scan is a
Python loop of small launches a layer over uniforms drawn first, so the
generator runs as one kernel: Philox draws in registers, the overlap walk
up the layers, the (L, g_pad, B) mask written once, pad rows included.

``subcol_mask`` on a CUDA tensor launches K8 (or raises: nothing falls
back); on a CPU tensor it runs the plain version, ``mcica.subcol_mask``
(or, given uniforms, ``mcica.mask_from_uniforms``).  Its launches count
in ``subcol_mask.launches``, those with given uniforms (the check entry)
in ``subcol_mask.given.launches``; every launch also counts in the
store path the kernel took, ``subcol_mask.vector.launches`` (whole-line
vector stores, where B % 4 == 0) or ``subcol_mask.scalar.launches``
(element stores).  ``philox_words`` is the Philox known-answer check:
the hand-written Philox, or curand's beside it.
"""

from __future__ import annotations

import torch

from .. import _build
from ..types import NGPT, NGPT_PAD
from . import mcica

DTYPES = (torch.float32, torch.float64)


def subcol_mask(k, icld: int, cldfrac, alpha=None, g_pad: int = NGPT_PAD,
                mask_dtype=None, uniforms=None):
    """The sub-column mask (L, g_pad, B) of key ``k`` for the cloud
    fraction ``cldfrac`` (B, L) and, for icld 4/5, ``alpha`` (B, L; None:
    0), in ``mask_dtype`` (int8 or the cloud fraction's type, the
    default), pad rows zero.  ``uniforms``: (u, u2) in the layout of
    ``mcica.overlap_cdf`` to use in place of the key's draws."""
    if cldfrac.device.type == "cpu":
        if uniforms is None:
            return mcica.subcol_mask(k, icld, cldfrac, alpha, g_pad,
                                     mask_dtype)
        return mcica.mask_from_uniforms(icld, cldfrac, *uniforms,
                                        alpha=alpha, g_pad=g_pad,
                                        mask_dtype=mask_dtype)
    if icld not in (1, 2, 3, 4, 5):
        raise ValueError(f"invalid icld={icld}")
    dt, device = cldfrac.dtype, cldfrac.device
    if dt not in DTYPES:
        raise TypeError(f"cldfrac: dtype {dt}, K8 takes {DTYPES}")
    mdt = dt if mask_dtype is None else mask_dtype
    if mdt not in (torch.int8, dt):
        raise TypeError(f"mask_dtype {mdt}: K8 writes int8 or {dt}")
    if g_pad < NGPT:
        raise ValueError(f"g_pad must be at least {NGPT}, got {g_pad}")
    B, L = cldfrac.shape
    _build.check(cldfrac, "cldfrac", dt, (B, L), device)
    if alpha is not None:
        _build.check(alpha, "alpha", dt, (B, L), device)
    u = u2 = None
    if uniforms is not None:
        u, u2 = uniforms
        _build.check(u, "u", dt, (u.shape[0] if icld == 3 else L, NGPT, B),
                     device)
        if icld in (4, 5):
            _build.check(u2, "u2", dt, (L, NGPT, B), device)
        else:
            u2 = None
        k = (0, 0)
    mask = torch.empty((L, g_pad, B), dtype=mdt, device=device)
    _build.launch("rrtm_mcica", cldfrac, alpha, u, u2, mask, k[0], k[1],
                  icld, int(dt == torch.float64), int(mdt == torch.int8), L,
                  B, g_pad)
    if uniforms is None:
        subcol_mask.launches += 1
    else:
        subcol_mask.given.launches += 1
    path = STORE_PATHS[_build.library().rrtm_mcica_path()]
    getattr(subcol_mask, path).launches += 1
    return mask


# rrtm_mcica_path's codes: the store path of K8's last launch
STORE_PATHS = {1: "vector", 2: "scalar"}

subcol_mask.launches = 0
subcol_mask.given = _build.Launches()
subcol_mask.vector = _build.Launches()
subcol_mask.scalar = _build.Launches()


def philox_words(ctr, k, curand: bool = False):
    """Philox4x32-10 of the counters ``ctr`` (n, 4) (int32 tensor of
    uint32 bits) under the key ``k``: (n, 4) words, int32 bits on the
    card (the hand-written Philox, or with ``curand`` curand's
    ``curand_Philox4x32_10``), int64 from ``mcica.philox4x32`` on the
    CPU (which has no curand)."""
    if ctr.device.type == "cpu":
        if curand:
            raise ValueError("curand's Philox runs on the card only")
        c = ctr.to(torch.int64) & mcica.M32
        return torch.stack(mcica.philox4x32(c.unbind(1), k), dim=1)
    n = ctr.shape[0]
    _build.check(ctr, "ctr", torch.int32, (n, 4), ctr.device)
    out = torch.empty_like(ctr)
    _build.launch("rrtm_philox", ctr, out, int(k[0]), int(k[1]), n,
                  int(curand))
    return out
