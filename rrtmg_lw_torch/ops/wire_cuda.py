"""K9, csrc/wire.cu: the wire format's decode on the card.

The JAX package decodes a ``WireBatch`` with jnp inside the jitted step,
fused by XLA (``rrtmg_lw_tpu/parallel/wire.py:256-279, 400-436``); run
op by op in PyTorch that is ~8-10 launches a coded channel, so the port
decodes every channel of a batch, the sanitize guards and the per-column
``ok`` included, in one launch of ``wire_decode_kernel``, and unpacks
the compact mask (``:586-590``) in one launch of ``wire_unpack_kernel``.

``wire_decode`` on a CUDA device launches K9 (or raises: nothing falls
back); on the CPU it runs the plain twin, ``parallel.wire.decode_plain``.
``wire_unpack_mask`` likewise (``parallel.wire.unpack_mask``).  Their
launches count in ``wire_decode.launches`` and
``wire_unpack_mask.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..parallel import wire

MAX_CHANNELS = 24
DTYPES = (torch.float32, torch.float64)
# csrc/wire.cu's Kind
KINDS = {"zero": 0, "uniform": 1, "logratio": 2, "delta": 3, "unit": 4,
         "linear": 5}


class WireChannel(ctypes.Structure):
    """csrc/wire.cu's WireChannel."""
    _fields_ = [("codes", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("ref", ctypes.c_void_p), ("lo", ctypes.c_void_p),
                ("hi", ctypes.c_void_p), ("fallback", ctypes.c_void_p),
                ("fill", ctypes.c_double), ("floor", ctypes.c_double),
                ("n", ctypes.c_longlong), ("row", ctypes.c_int),
                ("kind", ctypes.c_int), ("has_floor", ctypes.c_int),
                ("vec", ctypes.c_int)]


def _ptr(t):
    return None if t is None else t.data_ptr()


def descriptors(chans, outs, dtype, device):
    """The WireChannel table of ``chans`` (``parallel.wire.Channel``)
    writing into ``outs`` (name -> tensor), its tensors checked."""
    table = (WireChannel * len(chans))()
    for d, c in zip(table, chans):
        out = outs[c.name]
        n = out.numel()
        K = n // c.shape[0] if c.shape[0] else 1
        row_shape = tuple(c.shape[1:])
        kind = c.kind if c.mode == "coded" else c.mode
        if c.mode == "coded":
            _build.check(c.codes, f"{c.name} codes", torch.uint16, c.shape,
                         device)
        if kind in ("logratio", "delta", "uniform"):
            _build.check(c.refs[0], f"{c.name} ref", torch.float32,
                         row_shape, device)
        ranged = kind in ("logratio", "delta", "linear")
        if ranged:
            for t, what in zip(c.refs[-2:], ("lo", "hi")):
                _build.check(t, f"{c.name} {what}", torch.float32, (),
                             device)
        if c.fb_row is not None:
            _build.check(c.fb_row, f"{c.name} fallback", dtype, (K,), device)
        codes = c.codes if c.mode == "coded" else None
        d.codes, d.out = _ptr(codes), out.data_ptr()
        d.ref = _ptr(c.refs[0]) if kind in ("logratio", "delta",
                                            "uniform") else None
        d.lo, d.hi = (_ptr(c.refs[-2]), _ptr(c.refs[-1])) if ranged else \
            (None, None)
        d.fallback = _ptr(c.fb_row)
        d.fill = c.fill
        d.has_floor = c.floor is not None
        d.floor = c.floor or 0.0
        d.n, d.row, d.kind = n, K, KINDS[kind]
        d.vec = all(p % 16 == 0 for p in (d.out, d.codes or 0))
    return table


@functools.lru_cache(maxsize=None)
def _check_layout():
    """Raise unless csrc/wire.cu's WireChannel is laid out as here."""
    if _build.library().rrtm_wire_desc_size() != ctypes.sizeof(WireChannel):
        raise RuntimeError("csrc/wire.cu's WireChannel is not "
                           "ops/wire_cuda.py's")


def wire_decode(chans, dtype, device, ncol, sanitize=False):
    """Decode ``chans`` into fresh contiguous tensors of ``dtype`` on
    ``device``: -> ({name: tensor}, the (ncol,) bool ok with ``sanitize``,
    else None).  One launch of K9 on a CUDA device; the plain twin on the
    CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return wire.decode_plain(chans, dtype, device, ncol, sanitize)
    if dtype not in DTYPES:
        raise TypeError(f"K9 decodes to {DTYPES}, not {dtype}")
    if len(chans) > MAX_CHANNELS:
        raise ValueError(f"{len(chans)} channels: K9 takes at most "
                         f"{MAX_CHANNELS} a launch")
    if any(c.shape[0] != ncol for c in chans):
        raise ValueError(f"channels of {[c.shape for c in chans]}: K9 "
                         f"decodes {ncol} columns")
    outs = {c.name: torch.empty(c.shape, dtype=dtype, device=device)
            for c in chans}
    ok = (torch.ones((ncol,), dtype=torch.bool, device=device)
          if sanitize else None)
    if chans:
        _check_layout()
        table = descriptors(chans, outs, dtype, device)
        _build.launch("rrtm_wire_decode", ctypes.addressof(table),
                      len(chans), int(dtype == torch.float64),
                      int(sanitize), ok)
        wire_decode.launches += 1
    return outs, ok


wire_decode.launches = 0


def wire_unpack_mask(bits):
    """(L, nb, B) uint8 bits -> (L, 8 nb, B) int8 mask: K9's unpack on a
    CUDA tensor, ``parallel.wire.unpack_mask`` on a CPU one."""
    if bits.device.type == "cpu":
        return wire.unpack_mask(bits)
    L, nb, B = bits.shape
    _build.check(bits, "mask_bits", torch.uint8, (L, nb, B), bits.device)
    mask = torch.empty((L, nb * 8, B), dtype=torch.int8, device=bits.device)
    _build.launch("rrtm_wire_unpack", bits, mask, L, nb, B)
    wire_unpack_mask.launches += 1
    return mask


wire_unpack_mask.launches = 0
