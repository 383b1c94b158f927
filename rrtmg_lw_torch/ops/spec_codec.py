"""Reduced spectral storage of taug / fracs (``RRTMG_SPEC_DTYPE``).

Port of the codec of ``rrtmg_lw_tpu/ops/taumol_pallas.py:288-338`` and
of the storage switch read in ``PallasTaumol.__init__`` (``:696-710``).
The model reads ``RRTMG_SPEC_DTYPE`` once, at construction
(``spec_dtype_from_env``); in float32 it stores the (L, 140, B) taug
and fracs that taumol hands to the RT sweep in that dtype:

  '' / 'f32'  float32 (the default; nothing changes)
  'bf16'      bfloat16, a round-to-nearest-even cast; decode an upcast
  'f16'       float16, the same
  'logu16'    16-bit codes: taug log-quantized over od in [1e-9, 4]
              (code 0 the sentinel for x <= 1e-9), fracs linear in
              [0, 1]

logu16 codes are held as ``torch.uint16`` tensors.  PyTorch implements
few operations on that dtype, so the plain versions below move codes
through ``int16`` views, bit for bit (``_codes`` / ``_from_codes``);
the kernels read them as ``uint16_t``.

The functions keep the JAX package's float32 operation order (round half
to even, clip to [0, 65534], +1; decode ``exp(LO + u/scale - 1/scale)``),
with the constants copied as numbers: the card's machine has no JAX.
They are the plain versions of the encode in K2 (``csrc/taumol.cu``) and
the decode in K1 (``csrc/spec.cuh``).

Autodiff through reduced storage is unsupported, as in the JAX package
(``taumol_pallas.py:1415-1420``): quantized taug / fracs have no usable
cotangent, and the logu16 codes are integers that would silently cut the
gradient.  ``forbid_grad`` puts a node in the graph whose backward
raises ``NotImplementedError`` with the JAX package's wording.
"""

from __future__ import annotations

import os

import torch

# taumol_pallas.py:288-290: log(1e-9), log(4), 65534 / (HI - LO)
SPEC_LOG_LO = -20.72326583694641
SPEC_LOG_HI = 1.3862943611198906
_SPEC_LOG_SCALE = 65534.0 / (SPEC_LOG_HI - SPEC_LOG_LO)
_INV_SCALE = 1.0 / _SPEC_LOG_SCALE
_INV_FRAC = 1.0 / 65535.0

SPEC_DTYPES = {"": torch.float32, "f32": torch.float32,
               "bf16": torch.bfloat16, "f16": torch.float16,
               "logu16": torch.uint16}
# the kernels' storage argument (csrc/spec.cuh enum Spec)
SPEC_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.uint16: 3}
# the 16-bit storages (a float64 model's taug is float64, not reduced)
REDUCED = (torch.bfloat16, torch.float16, torch.uint16)
ENV = "RRTMG_SPEC_DTYPE"
GRAD_MESSAGE = ("autodiff through reduced spectral storage "
                "(RRTMG_SPEC_DTYPE) is unsupported: quantized "
                "taug/fracs have no usable cotangent — unset the "
                "knob for training runs")


def spec_dtype_from_env() -> torch.dtype:
    """The storage dtype ``RRTMG_SPEC_DTYPE`` names; ValueError (the
    JAX package's wording) for any other value."""
    sdt = os.environ.get(ENV, "")
    if sdt not in SPEC_DTYPES:
        raise ValueError(
            f"RRTMG_SPEC_DTYPE={sdt!r} is not a valid spectral "
            f"storage dtype; allowed values: '' (default f32), "
            f"'f32', 'bf16', 'f16', 'logu16'")
    return SPEC_DTYPES[sdt]


def _from_codes(u: torch.Tensor) -> torch.Tensor:
    """uint16 codes -> int32 values in [0, 65535]."""
    return u.view(torch.int16).to(torch.int32) & 0xFFFF


def _codes(v: torch.Tensor) -> torch.Tensor:
    """float32 values in [0, 65535] (whole numbers) -> uint16 codes."""
    return v.to(torch.int32).to(torch.int16).view(torch.uint16)


def spec_encode_taug(x: torch.Tensor) -> torch.Tensor:
    """float32 taug -> logu16 codes (x <= 1e-9, including the tiny
    negatives of corradj cancellation, to the zero sentinel)."""
    pos = x > 1e-9
    e = torch.log(torch.clamp(x, min=1e-9))
    u = torch.clamp(torch.round((e - SPEC_LOG_LO) * _SPEC_LOG_SCALE),
                    0.0, 65534.0) + 1.0
    return _codes(torch.where(pos, u, torch.zeros_like(u)))


def spec_decode_taug(u: torch.Tensor) -> torch.Tensor:
    uf = _from_codes(u).to(torch.float32)
    v = torch.exp(SPEC_LOG_LO + uf * _INV_SCALE - _INV_SCALE)
    return torch.where(uf == 0.0, torch.zeros_like(v), v)


def spec_encode_frac(f: torch.Tensor) -> torch.Tensor:
    return _codes(torch.round(torch.clamp(f, 0.0, 1.0) * 65535.0))


def spec_decode_frac(u: torch.Tensor) -> torch.Tensor:
    return _from_codes(u).to(torch.float32) * _INV_FRAC


def spec_store(x: torch.Tensor, dtype: torch.dtype, which: str):
    """float32 taug (``which="tg"``) or fracs (``"fr"``) in storage
    ``dtype``: the plain version of K2's store."""
    if dtype == torch.uint16:
        return spec_encode_taug(x) if which == "tg" else spec_encode_frac(x)
    return x.to(dtype)


def spec_load_taut(x: torch.Tensor) -> torch.Tensor:
    """Storage dtype -> float32: decode (logu16) or upcast."""
    if x.dtype == torch.uint16:
        return spec_decode_taug(x)
    return x.to(torch.float32)


def spec_load_frac(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.uint16:
        return spec_decode_frac(x)
    return x.to(torch.float32)


def spec_order(x: torch.Tensor) -> torch.Tensor:
    """16-bit storage -> int32 keys in the storage's order (logu16 codes
    as 0..65535; bf16 / f16 bit patterns with the sign folded), so that
    neighbouring stored values differ by 1: the distance in storage
    steps between two encodes."""
    v = x.view(torch.int16).to(torch.int32)
    if x.dtype == torch.uint16:
        return v & 0xFFFF
    return torch.where(v < 0, -(v & 0x7FFF), v)


def spec_inputs(taut_t, fracs_t, taua_t, ngb0):
    """The float32 taut, fracs (L, 140, B) the RT sweep reads: as given
    when ``taua_t`` is None (float32 storage, aerosol already added),
    else decoded from storage plus taua_t (L, 16, B) of each g's band,
    as K1 does it in reduced storage (rtrn_pallas.py:260-275)."""
    if taua_t is None:
        return taut_t, fracs_t
    return (spec_load_taut(taut_t) + taua_t.index_select(1, ngb0.long()),
            spec_load_frac(fracs_t))


class _NoGrad(torch.autograd.Function):
    """Identity on ``x``; its backward raises."""

    @staticmethod
    def forward(ctx, x, *anchors):
        return x.clone()

    @staticmethod
    def backward(ctx, *ct):
        raise NotImplementedError(GRAD_MESSAGE)


def forbid_grad(x: torch.Tensor, anchors) -> torch.Tensor:
    """``x``, made to raise NotImplementedError in any backward that
    reaches it or the tensors ``anchors`` (the inputs of the quantized
    taumol): the cotangent through reduced storage is refused, never
    silently zero.  Without grad mode, or when nothing requires grad,
    ``x`` itself."""
    if torch.is_grad_enabled() and (
            x.requires_grad or any(a.requires_grad for a in anchors)):
        return _NoGrad.apply(x, *anchors)
    return x
