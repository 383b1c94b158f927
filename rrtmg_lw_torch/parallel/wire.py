"""The compressed host->device wire format, and its device-side decode.

Port of ``rrtmg_lw_tpu.parallel.wire``.  A streaming deployment is bound
by the host link, not the card, so the host ships compact integer codes
and the device decodes them inside the step:

* per-BATCH float32 reference profiles (one (L,) median profile per
  field), plus
* per-column uint16 codes against that reference: ``logratio`` (smooth
  positive fields, quantized log(x / ref); code 0 an exact zero),
  ``delta`` (temperatures, quantized x - ref), ``unit`` (fixed [0, 1]
  quantization) and ``linear`` (per-batch [lo, hi] quantization);
* all-zero channels as a flag, column-uniform ones as one float32 row.

The encoders, ``validate_wire``, ``save_wire`` / ``load_wire`` (the same
``.npz`` layout byte for byte, so shards move between the two packages)
and ``wire_bytes`` are host numpy, copied as they are; the encoders run
the C++ codec (``rrtmg_lw_torch.native``, ``native/wirecodec.cc``,
bit-identical to the numpy reference) where it builds, unless
``RRTMG_WIRE_NATIVE=0``.

The decoders (``decode_atmosphere``, ``decode_cloud_profiles``,
``decode_compact_clouds``) take a ``WireBatch`` whose codes and
references are tensors (``parallel.shard_batch`` / ``prefetch`` place
them; host arrays are moved to the device of ``tauaer`` / ``like`` / the
mask).  On a CUDA tensor every channel of a batch is decoded by one
launch of K9 (``ops.wire_cuda``, ``csrc/wire.cu``), the sanitize guards
and the per-column ``ok`` included, and the compact mask is unpacked by
K9's second kernel; on a CPU tensor they run the plain twin here
(``decode_plain``, ``unpack_mask``), which follows the JAX decoders op
for op: the reference K9 is held to.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..types import Atmosphere, McicaCloudsCompact

_U16 = 65535.0


class WireBatch(NamedTuple):
    """cols: name -> (B, ...) uint16 codes (cut over the columns);
    refs: name -> small f32 reference/range arrays (replicated)."""
    cols: dict
    refs: dict


# ---------------------------------------------------------------------------
# host-side encoders (C++ via ctypes when it builds — bit-identical spec,
# see native/wirecodec.cc — else numpy)
# ---------------------------------------------------------------------------
def _native():
    if os.environ.get("RRTMG_WIRE_NATIVE", "1") == "0":
        return None
    from .. import native
    return native if native.wire_native_available() else None


def _check_frozen_width(lo, hi, values):
    """A zero-width frozen range is only usable when the data sits ON
    it (a genuinely constant channel; everything decodes to the
    constant).  Data varying beyond the range would silently saturate
    to a single value — raise instead (the refs were captured from a
    constant batch; re-capture from a representative varying one)."""
    width = hi - lo
    if width > 0.0:
        return
    v = np.asarray(values, np.float64)
    if v.size and (np.abs(v - lo).max() > 1e-9 + 1e-6 * abs(lo)):
        raise ValueError(
            "frozen wire refs have zero range but this batch varies "
            "across it — the refs were captured from a constant "
            "batch; capture them from a representative varying batch "
            "(or leave the channel uniform)")


def _enc_logratio(x, frozen=None):
    """(codes uint16, refs (ref_level, lo, hi)).  Code 0 == exact 0.

    ``frozen``: a refs tuple from a previous batch (or climatology) —
    codes are then computed against those FIXED references/ranges
    (values outside the range saturate at the range edges), making
    codes deterministic across batches and hosts (the multi-host
    contract: every host must quantize against the same refs)."""
    if frozen is not None:
        ref32, lo, hi = frozen
        ref = np.asarray(ref32, np.float64)
        x = np.asarray(x, np.float64)
        pos = x > 0.0
        lo, hi = float(lo), float(hi)
        _check_frozen_width(lo, hi, np.where(pos, np.log(
            np.where(pos, x, 1.0) / ref), lo))
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where(pos, np.log(x / ref), 0.0)
        u = np.clip(np.rint((r - lo) / max(hi - lo, 1e-300)
                            * (_U16 - 1.0)),
                    0, _U16 - 1.0).astype(np.int64) + 1
        u = np.where(pos, u, 0)
        return u.astype(np.uint16), frozen
    nat = _native()
    if nat is not None and np.ndim(x) >= 1:
        u, ref, lo, hi, _npos = nat.wire_enc_logratio(
            np.asarray(x, np.float64))
        return u, (ref.astype(np.float32), np.float32(lo),
                   np.float32(hi))
    x = np.asarray(x, np.float64)
    ref = np.median(x, axis=0)                    # (L,) or ()
    pos = x > 0.0
    ref = np.where(ref > 0.0, ref,
                   np.where(pos, x, 1.0).max(axis=0))
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(pos, np.log(x / ref), 0.0)
    rv = r[pos] if pos.any() else np.zeros(1)
    lo, hi = float(rv.min()), float(rv.max())
    hi = max(hi, lo + 1e-12)
    u = np.rint((r - lo) / (hi - lo) * (_U16 - 1.0)).astype(np.int64) + 1
    u = np.where(pos, u, 0)
    return u.astype(np.uint16), (ref.astype(np.float32),
                                 np.float32(lo), np.float32(hi))


def _enc_delta(x, frozen=None):
    if frozen is not None:
        ref32, lo, hi = frozen
        d = np.asarray(x, np.float64) - np.asarray(ref32, np.float64)
        lo, hi = float(lo), float(hi)
        _check_frozen_width(lo, hi, d)
        u = np.clip(np.rint((d - lo) / max(hi - lo, 1e-300) * _U16),
                    0, _U16).astype(np.uint16)
        return u, frozen
    nat = _native()
    if nat is not None and np.ndim(x) >= 1:
        u, ref, lo, hi, _ = nat.wire_enc_delta(np.asarray(x, np.float64))
        return u, (ref.astype(np.float32), np.float32(lo),
                   np.float32(hi))
    x = np.asarray(x, np.float64)
    ref = np.median(x, axis=0)
    d = x - ref
    lo, hi = float(d.min()), float(d.max())
    hi = max(hi, lo + 1e-12)
    u = np.rint((d - lo) / (hi - lo) * _U16).astype(np.uint16)
    return u, (ref.astype(np.float32), np.float32(lo), np.float32(hi))


def _enc_unit(x, frozen=None):
    u = np.rint(np.clip(np.asarray(x, np.float64), 0.0, 1.0) * _U16)
    return u.astype(np.uint16), ()


def _enc_linear(x, frozen=None):
    x = np.asarray(x, np.float64)
    if frozen is not None:
        lo, hi = float(frozen[0]), float(frozen[1])
        _check_frozen_width(lo, hi, x)
        u = np.clip(np.rint((x - lo) / max(hi - lo, 1e-300) * _U16),
                    0, _U16).astype(np.uint16)
        return u, frozen
    lo, hi = float(x.min()), float(x.max())
    hi = max(hi, lo + 1e-12)
    u = np.rint((x - lo) / (hi - lo) * _U16).astype(np.uint16)
    return u, (np.float32(lo), np.float32(hi))


# ---------------------------------------------------------------------------
# structural validation (host-side, at the ingest boundary)
# ---------------------------------------------------------------------------
def _validate_batch(fields, wire, where):
    B = None
    for name, u in wire.cols.items():
        u = np.asarray(u)
        if u.dtype != np.uint16:
            raise ValueError(f"{where}: channel {name!r} codes have "
                             f"dtype {u.dtype}, expected uint16")
        if u.ndim < 1 or u.shape[0] == 0:
            raise ValueError(f"{where}: channel {name!r} codes are "
                             f"empty/scalar (shape {u.shape}) — "
                             "truncated batch?")
        if B is None:
            B = u.shape[0]
        elif u.shape[0] != B:
            raise ValueError(
                f"{where}: channel {name!r} has batch dim "
                f"{u.shape[0]} but other channels have {B} — "
                "truncated batch")
        if name not in wire.refs:
            raise ValueError(f"{where}: channel {name!r} has codes "
                             "but no refs entry")
    for name, r in wire.refs.items():
        kind = fields.get(name)
        if kind is None:
            raise ValueError(f"{where}: unknown channel {name!r}")
        if r is None or isinstance(r, dict):
            continue                    # zero / uniform: no codes
        if kind == "unit":
            if len(r) != 0:
                raise ValueError(f"{where}: unit channel {name!r} "
                                 f"carries refs {r!r}")
        elif kind == "linear":
            if len(r) != 2:
                raise ValueError(f"{where}: linear channel {name!r} "
                                 f"refs arity {len(r)} != 2")
        elif len(r) != 3:
            raise ValueError(f"{where}: {kind} channel {name!r} "
                             f"refs arity {len(r)} != 3")
        if name not in wire.cols:
            raise ValueError(f"{where}: coded channel {name!r} has "
                             "refs but its codes are missing — "
                             "truncated batch")
    return B


def validate_wire(wire, *, fields=None) -> int:
    """Structural validation of an incoming WireBatch /
    CompactCloudsWire at the host ingest boundary (BEFORE the copy to the device):
    code dtypes, refs arity, per-channel batch-dim consistency, known
    channel names.  Raises ValueError naming the offending channel;
    returns the batch size.  Value-level corruption (NaN/Inf refs,
    inverted ranges) is the on-device ``sanitize=True`` decode path's
    job — a device-resident pipeline never re-hosts refs to check
    them."""
    if isinstance(wire, CompactCloudsWire):
        bits = np.asarray(wire.mask_bits)
        if bits.dtype != np.uint8 or bits.ndim != 3:
            raise ValueError(
                f"compact-clouds wire: mask_bits dtype/ndim "
                f"{bits.dtype}/{bits.ndim}, expected uint8 (L, G/8, B)")
        B = _validate_batch(COMPACT_CLOUD_FIELDS, wire.fields,
                            "compact-clouds wire")
        if B is not None and bits.shape[2] != B:
            raise ValueError(
                f"compact-clouds wire: mask batch dim {bits.shape[2]} "
                f"!= field batch dim {B} — truncated batch")
        return bits.shape[2]
    known = dict(ATM_FIELDS)
    known.update(CLOUD_FIELDS)
    B = _validate_batch(fields or known, wire, "wire batch")
    if B is None:
        raise ValueError("wire batch has no per-column codes — pass "
                         "fields= if every channel is zero/uniform")
    return B


# ---------------------------------------------------------------------------
# device-side decoders: the plain twin of K9 (torch, op for op the JAX
# decoders, rrtmg_lw_tpu/parallel/wire.py:256-279)
# ---------------------------------------------------------------------------
def _codes(u):
    """uint16 codes as int32 (exact)."""
    return u.to(torch.int32)


def _div(x, n):
    """``x / n`` rounded as a division: a divisor on ``x``'s device (torch
    on CUDA multiplies by the reciprocal of a Python scalar divisor)."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def _dec_logratio(u, refs, dtype):
    ref, lo, hi = refs
    u = _codes(u)
    # (hi - lo) / (_U16 - 1) in float32, as the JAX decoder on float32 refs
    r = lo.to(dtype) + (u.to(dtype) - 1.0) * _div(hi - lo, _U16 - 1.0
                                                  ).to(dtype)
    return torch.where(u == 0, 0.0, ref.to(dtype) * torch.exp(r))


def _dec_delta(u, refs, dtype):
    ref, lo, hi = refs
    return (ref.to(dtype) + lo.to(dtype)
            + _codes(u).to(dtype) * _div(hi - lo, _U16).to(dtype))


def _dec_unit(u, refs, dtype):
    return _div(_codes(u).to(dtype), _U16)


def _dec_linear(u, refs, dtype):
    lo, hi = refs
    return lo.to(dtype) + _codes(u).to(dtype) * _div(hi - lo, _U16).to(dtype)


_CODECS = {"logratio": (_enc_logratio, _dec_logratio),
           "delta": (_enc_delta, _dec_delta),
           "unit": (_enc_unit, _dec_unit),
           "linear": (_enc_linear, _dec_linear)}

# field -> codec kind
ATM_FIELDS = {
    "play": "logratio", "plev": "logratio",
    "tlay": "delta", "tlev": "delta", "tsfc": "delta",
    "h2ovmr": "logratio", "co2vmr": "logratio", "o3vmr": "logratio",
    "n2ovmr": "logratio", "covmr": "logratio", "ch4vmr": "logratio",
    "o2vmr": "logratio", "cfc11vmr": "logratio",
    "cfc12vmr": "logratio", "cfc22vmr": "logratio",
    "ccl4vmr": "logratio",
    "emis": "unit",
}
CLOUD_FIELDS = {
    "cldfrac": "unit", "ciwp": "logratio", "clwp": "logratio",
    "rei": "linear", "rel": "linear",
}


def _encode(fields, tree_dict, schema=None, frozen=None):
    """schema: None (auto-detect zero/uniform/coded per channel — the
    smallest wire, but the WireBatch's STRUCTURE then depends on
    the data, and a channel changing category between batches changes
    what the consuming step receives), or "coded" (every present channel fully
    encoded — stable structure for streams), or a {name: mode} dict
    captured from a representative batch via ``schema_of`` (raises on
    violation instead of silently changing structure).

    frozen: a previous WireBatch.refs — coded channels are then
    quantized against those FIXED references/ranges (out-of-range
    values saturate), so codes are deterministic across batches AND
    across hosts (every host of a multi-host mesh must pass the same
    refs; per-batch medians would differ per host).  Implies the
    frozen batch's schema unless one is given."""
    if frozen is not None and schema is None:
        schema = {name: ("zero" if r is None
                         else "uniform" if isinstance(r, dict)
                         else "coded")
                  for name, r in frozen.items()}
    if schema == "coded":
        schema = {name: "coded" for name in fields}
    cols, refs = {}, {}
    _MISSING = object()
    for name, kind in fields.items():
        if name not in tree_dict:
            continue
        x = np.asarray(tree_dict[name])
        mode = (schema or {}).get(name)
        if mode is None:
            # auto-detect (two full-array scans — skipped when the
            # schema pins the mode, keeping the hot coded path at one
            # pass on the prefetch thread)
            mode = ("zero" if not x.any()
                    else "uniform" if (x.ndim > 1
                                       and bool((x == x[:1]).all()))
                    else "coded")
        if mode == "zero":
            if x.any():
                raise ValueError(
                    f"wire schema violation: channel {name!r} is "
                    "declared all-zero but this batch has data "
                    "(re-capture the schema; the consuming jit must "
                    "recompile for the new structure)")
            refs[name] = None          # all-zero channel: flag only
        elif mode == "uniform":
            if not (x.ndim > 1 and bool((x == x[:1]).all())):
                raise ValueError(
                    f"wire schema violation: channel {name!r} is "
                    "declared column-uniform but this batch varies "
                    "per column (re-capture the schema)")
            # column-uniform channel (well-mixed gases in GCM feeds,
            # constant particle sizes): ship ONE exact f32 row per
            # batch, zero bytes per column
            refs[name] = {"uniform": x[0].astype(np.float32)}
        else:
            enc, _ = _CODECS[kind]
            fz = None
            if frozen is not None and kind != "unit":
                fz = frozen.get(name, _MISSING)
                if fz is _MISSING or fz is None or isinstance(fz, dict):
                    # silently re-ranging per batch/host would defeat
                    # the determinism contract refs= exists for
                    raise ValueError(
                        f"refs= has no coded reference for channel "
                        f"{name!r} (it was "
                        f"{'absent' if fz is _MISSING else 'zero/uniform'} "
                        "in the captured batch) — capture refs with "
                        "schema='coded' from a representative varying "
                        "batch")
            cols[name], refs[name] = enc(x, frozen=fz)
    return WireBatch(cols, refs)


def schema_of(wire: WireBatch) -> dict:
    """{channel: 'zero' | 'uniform' | 'coded'} of an encoded batch —
    pass to encode_* to pin the structure across a stream."""
    return {name: ("zero" if r is None
                   else "uniform" if isinstance(r, dict) else "coded")
            for name, r in wire.refs.items()}


def to_device(x, device, non_blocking=False):
    """A host array or tensor as a tensor on ``device`` (uint16 codes
    cross as int16, viewed back: the copy moves bytes only)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(device, non_blocking=non_blocking
                                      ).view(torch.uint16)
    return t.to(device, non_blocking=non_blocking)


class Channel(NamedTuple):
    """One field of a decode, on the device: ``mode`` "zero", "uniform"
    or "coded"; ``codes`` (shape) uint16 where coded; ``refs`` float32
    tensors, (ref (K,), lo, hi), (lo, hi) or () where coded, (row (K,),)
    where uniform; the sanitize floor (or None) and fallback: the row
    ``fb_row`` (K,) in the decode's type, else the constant ``fill``."""
    name: str
    kind: str
    mode: str
    shape: tuple
    codes: Optional[torch.Tensor]
    refs: tuple
    floor: Optional[float]
    fb_row: Optional[torch.Tensor]
    fill: float


def _channels(fields, wire, shape_of, dtype, device, floors=None,
              fallback_of=None):
    """The ``Channel`` of every field of ``fields`` present in ``wire``
    (``_decode``'s walk), its leaves moved to ``device``."""
    out = []
    for name, kind in fields.items():
        if name not in wire.refs:
            continue
        r = wire.refs[name]
        shape = tuple(shape_of(name))
        codes, refs = None, ()
        if r is None:
            mode = "zero"
        elif isinstance(r, dict):
            mode = "uniform"
            refs = (to_device(r["uniform"], device).float(),)
        else:
            mode = "coded"
            codes = to_device(wire.cols[name], device)
            refs = tuple(to_device(x, device).float() for x in r)
        row, fill = (fallback_of(name, shape, dtype, device)
                     if fallback_of else (None, 0.0))
        out.append(Channel(name, kind, mode, shape, codes, refs,
                           (floors or {}).get(name), row, fill))
    return out


def _refs_ok(c, device):
    """0-d bool: the channel's references are finite and its quantization
    range is ordered (rrtmg_lw_tpu/parallel/wire.py:382-397).  Corrupt
    refs poison every decoded element of the batch, so the granularity
    is per-channel."""
    r = c.refs
    if not r:
        return torch.ones((), dtype=torch.bool, device=device)
    if c.mode == "uniform":
        return torch.isfinite(r[0]).all()
    lo, hi = r[-2:]
    ok = torch.isfinite(lo) & torch.isfinite(hi) & (hi >= lo)
    return torch.isfinite(r[0]).all() & ok if len(r) == 3 else ok


def decode_plain(chans, dtype, device, ncol, sanitize=False):
    """The plain twin of K9: {name: decoded tensor} and, with
    ``sanitize``, the (ncol,) bool ``ok`` (else None), as ``_decode``
    (rrtmg_lw_tpu/parallel/wire.py:400-436): a guarded channel's
    non-finite values, values at or below its floor, and every value
    decoded from corrupt refs replaced by its fallback, the columns they
    touch flagged."""
    out = {}
    ok = torch.ones((ncol,), dtype=torch.bool, device=device) \
        if sanitize else None
    for c in chans:
        if c.mode == "zero":
            out[c.name] = torch.zeros(c.shape, dtype=dtype, device=device)
            continue                   # exact zeros: nothing to guard
        if c.mode == "uniform":
            x = c.refs[0].to(dtype).expand(c.shape).contiguous()
        else:
            x = _CODECS[c.kind][1](c.codes, c.refs, dtype)
        if sanitize:
            cok = _refs_ok(c, device)
            bad = ~torch.isfinite(x)
            if c.floor is not None:
                bad = bad | (x <= c.floor)
            fb = (c.fb_row.expand(c.shape) if c.fb_row is not None
                  else torch.full(c.shape, c.fill, dtype=dtype,
                                  device=device))
            x = torch.where(bad | ~cok, fb, x)
            ok = ok & cok & ~bad.reshape(x.shape[0], -1).any(dim=1)
        out[c.name] = x
    return out, ok


def _decode(fields, wire, shape_of, dtype, device, ncol, sanitize=False,
            floors=None, fallback_of=None):
    """Decode ``fields`` of ``wire`` onto ``device``: K9 on a CUDA device
    (``ops.wire_cuda.wire_decode``, one launch), the plain twin on the
    CPU.  -> (dict, ok or None)."""
    chans = _channels(fields, wire, shape_of, dtype, device, floors,
                      fallback_of)
    from ..ops.wire_cuda import wire_decode
    return wire_decode(chans, dtype, device, ncol, sanitize)


def encode_atmosphere(atm, schema=None, refs=None) -> WireBatch:
    """Atmosphere (or its field dict; host numpy arrays or CPU tensors, f32/f64)
    -> WireBatch.  ``tauaer`` is intentionally NOT shipped (the device
    keeps a resident aerosol state; pass it to decode_atmosphere).
    ``schema``/``refs``: see _encode — pin them across a stream (and
    across hosts) for a stable structure and deterministic
    codes."""
    d = atm if isinstance(atm, dict) else atm._asdict()
    d = {k: v for k, v in d.items() if k != "tauaer"}
    return _encode(ATM_FIELDS, d, schema, refs)


# physical floors for sanitized decode: values at/below these feed
# logs/divisions downstream (setcoef's log(pavel), Planck temperature
# indexing), so they are corruption, not data
_ATM_FLOORS = {"play": 0.0, "tlay": 0.0, "tlev": 0.0, "tsfc": 0.0}


def _linspace(start, stop, num, dtype, device):
    """``jnp.linspace(start, stop, num, dtype=dtype)`` op for op:
    start * (1 - s) + stop * s, s = i / (num - 1), the endpoint exact."""
    s = (torch.arange(num - 1, dtype=dtype, device=device)
         / torch.tensor(num - 1, dtype=dtype, device=device))
    a, b = (torch.tensor(v, dtype=dtype, device=device)
            for v in (start, stop))
    return torch.cat([a * (1 - s) + b * s, b[None]])


@functools.lru_cache(maxsize=32)
def _pressure_row(name, K, dtype, device):
    """The fallback row (K,) of plev or play (cached: read, never
    written)."""
    if name == "plev":
        return _linspace(1013.0, 1e-2, K, dtype, device)
    edges = _linspace(1013.0, 1e-2, K + 1, dtype, device)
    return 0.5 * (edges[:-1] + edges[1:])


def _atm_fallback(name, shape, dtype, device):
    """A finite, physically valid stand-in per field (the JAX package's
    ``_atm_fallback``): corrupted channels decode to a standard-ish
    column (monotone pressure grid, temperate profile) so the radiation
    step stays finite end to end; the wire_ok flag records which columns
    were replaced.  -> (a (K,) row or None, the constant otherwise)."""
    if name in ("plev", "play"):
        return _pressure_row(name, shape[1], dtype, torch.device(device)), 0.0
    return None, {"tlay": 250.0, "tlev": 250.0, "tsfc": 288.0,
                  "emis": 1.0}.get(name, 0.0)   # gas vmr: zero is valid


def decode_atmosphere(wire: WireBatch, tauaer, dtype=torch.float32, *,
                      sanitize: bool = False):
    """-> Atmosphere, or (Atmosphere, ok) with ``sanitize=True``, on
    ``tauaer``'s device (the device-resident aerosol state, which also
    gives B and L: every channel may be uniform or zero).

    ``sanitize`` hardens the ingest boundary: corrupted wire content
    (NaN/Inf references, inverted quantization ranges, codes decoding to
    nonpositive pressures/temperatures) is replaced per channel by finite
    fallback profiles and ``ok`` — a (B,) bool, False for affected
    columns — is returned for the step to thread into ``Fluxes.wire_ok``."""
    tauaer = torch.as_tensor(tauaer)
    B, L = tauaer.shape[:2]

    def shape_of(name):
        return {"tsfc": (B,), "emis": (B, 16),
                "plev": (B, L + 1), "tlev": (B, L + 1)}.get(name, (B, L))

    d, ok = _decode(ATM_FIELDS, wire, shape_of, dtype, tauaer.device, B,
                    sanitize, _ATM_FLOORS, _atm_fallback if sanitize else None)
    atm = Atmosphere(tauaer=tauaer, **d)
    return (atm, ok) if sanitize else atm


def encode_cloud_profiles(cp: dict, schema=None, refs=None
                          ) -> WireBatch:
    """(B, L) cloud profile fields {cldfrac, ciwp, clwp, rei, rel}
    (the device-side McICA generator's inputs) -> WireBatch."""
    return _encode(CLOUD_FIELDS, cp, schema, refs)


def decode_cloud_profiles(wire: WireBatch, dtype=torch.float32, *,
                          like=None, sanitize: bool = False):
    """``like``: any (B, L) tensor supplying the output shape and device
    (e.g. the decoded atmosphere's ``play``) — required when EVERY cloud
    channel is zero/uniform (a fully clear or constant-cloud batch ships
    no per-column codes at all); without it the codes' device.

    ``sanitize``: guard against corrupt refs (see decode_atmosphere);
    returns (dict, ok (B,) bool).  Cloud fallbacks are all-clear
    (zeros)."""
    if like is not None:
        shape = tuple(like.shape)
        device = like.device if isinstance(like, torch.Tensor) \
            else torch.device("cpu")
    elif wire.cols:
        first = next(iter(wire.cols.values()))
        shape = tuple(first.shape)
        device = first.device if isinstance(first, torch.Tensor) \
            else torch.device("cpu")
    else:
        raise ValueError(
            "decode_cloud_profiles: no per-column codes in this batch "
            "(all channels zero/uniform) — pass like=<any (B, L) "
            "array> for the output shape")
    d, ok = _decode(CLOUD_FIELDS, wire, lambda name: shape, dtype, device,
                    shape[0], sanitize)
    return (d, ok) if sanitize else d


# ---------------------------------------------------------------------------
# host-generated McICA sub-columns (the reference GCM contract takes
# cldfmcl as an INPUT, rrtmg_lw_rad.f90:117): bit-packed mask wire
# ---------------------------------------------------------------------------
class CompactCloudsWire(NamedTuple):
    """McicaCloudsCompact on the wire: the binary sub-column mask
    bit-packed 8-to-1 (columns stay on the last axis, like the blocked
    layouts) + the per-layer water/size fields as uint16 codes.
    ~1.4 KB/col at nlay=60 vs ~9.6 KB for the int8-mask compact form."""
    mask_bits: object          # (L, NGPT_PAD // 8, B) uint8
    fields: WireBatch          # ciwp/clwp (logratio), reic/relq (linear)


COMPACT_CLOUD_FIELDS = {"ciwp": "logratio", "clwp": "logratio",
                        "reicmc": "linear", "relqmc": "linear"}


def encode_compact_clouds(clouds, schema=None) -> CompactCloudsWire:
    """McicaCloudsCompact (host arrays) -> CompactCloudsWire.  The
    mask packs losslessly (bitorder little: g-point 8*b + k is bit k
    of byte b); water paths/particle sizes go through the standard
    uint16 codecs."""
    mask = np.asarray(clouds.cldfmc)
    bits = np.packbits(mask.astype(bool), axis=1, bitorder="little")
    d = {k: np.asarray(getattr(clouds, k))
         for k in COMPACT_CLOUD_FIELDS}
    return CompactCloudsWire(bits, _encode(COMPACT_CLOUD_FIELDS, d,
                                           schema))


def unpack_mask(bits):
    """(L, nb, B) uint8 bits -> (L, 8 nb, B) int8 mask, bit k of byte b
    the g-point 8 b + k (rrtmg_lw_tpu/parallel/wire.py:586-590): the plain
    twin of K9's unpack."""
    L, nb, B = bits.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return ((bits[:, :, None, :] >> shifts[None, None, :, None]) & 1
            ).reshape(L, nb * 8, B).to(torch.int8)


def decode_compact_clouds(wire: CompactCloudsWire, dtype=torch.float32,
                          mask_dtype=None, *, sanitize: bool = False):
    """-> McicaCloudsCompact (or (clouds, ok (B,) bool) with
    ``sanitize=True``) on the mask bits' device, the mask unpacked there
    (K9's unpack on the card) into int8 (or ``mask_dtype``).  The
    bit-packed mask cannot encode non-finite values; corruption enters
    through the uint16 field refs, which sanitize guards."""
    bits = wire.mask_bits
    device = bits.device if isinstance(bits, torch.Tensor) \
        else torch.device("cpu")
    bits = to_device(bits, device)
    L, nb, B = bits.shape
    from ..ops.wire_cuda import wire_unpack_mask
    mask = wire_unpack_mask(bits)
    if mask_dtype is not None:
        mask = mask.to(mask_dtype)
    d, ok = _decode(COMPACT_CLOUD_FIELDS, wire.fields, lambda name: (B, L),
                    dtype, device, B, sanitize)
    clouds = McicaCloudsCompact(cldfmc=mask, **d)
    return (clouds, ok) if sanitize else clouds


# ---------------------------------------------------------------------------
# on-disk shard format: encoded batches persist as single .npz files
# (the replacement for the reference's per-column text
# decks as a bulk input format — rrtmg_lw.1col.f90:447; a stored
# shard is byte-for-byte what crosses the wire)
# ---------------------------------------------------------------------------
def save_wire(path, wire) -> None:
    """Persist a WireBatch or CompactCloudsWire to ``path`` (.npz)."""
    flat = {}
    if isinstance(wire, CompactCloudsWire):
        flat["__kind__"] = np.array("compact_clouds")
        flat["mask_bits"] = np.asarray(wire.mask_bits)
        wb = wire.fields
    else:
        flat["__kind__"] = np.array("batch")
        wb = wire
    for k, v in wb.cols.items():
        flat[f"c:{k}"] = np.asarray(v)
    for k, r in wb.refs.items():
        if r is None:
            flat[f"z:{k}"] = np.array(0, np.uint8)
        elif isinstance(r, dict):
            flat[f"u:{k}"] = np.asarray(r["uniform"])
        elif len(r) == 0:              # unit codec: fixed range
            flat[f"e:{k}"] = np.array(0, np.uint8)
        elif len(r) == 2:              # linear codec: (lo, hi)
            flat[f"s:{k}"] = np.array(r, np.float32)
        else:                          # logratio/delta: (ref, lo, hi)
            ref, lo, hi = r
            flat[f"r:{k}"] = np.asarray(ref)
            flat[f"s:{k}"] = np.array([lo, hi], np.float32)
    np.savez(path, **flat)


def load_wire(path):
    """Load a shard saved by ``save_wire`` (WireBatch or
    CompactCloudsWire, host numpy — ready for prefetch / shard_batch)."""
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["__kind__"])
        cols, refs = {}, {}
        has_r = {k.partition(":")[2] for k in z.files
                 if k.startswith("r:")}
        for k in z.files:
            tag, _, name = k.partition(":")
            if tag == "c":
                cols[name] = z[k]
            elif tag == "z":
                refs[name] = None
            elif tag == "u":
                refs[name] = {"uniform": z[k]}
            elif tag == "e":
                refs[name] = ()
            elif tag == "r":
                s = z[f"s:{name}"]
                refs[name] = (z[k], np.float32(s[0]), np.float32(s[1]))
            elif tag == "s" and name not in has_r:
                refs[name] = (np.float32(z[k][0]), np.float32(z[k][1]))
        wb = WireBatch(cols, refs)
        if kind == "compact_clouds":
            return CompactCloudsWire(z["mask_bits"], wb)
    return wb


def wire_bytes(wire) -> int:
    if isinstance(wire, CompactCloudsWire):
        return (int(np.asarray(wire.mask_bits).nbytes)
                + wire_bytes(wire.fields))
    n = sum(int(np.asarray(v).nbytes) for v in wire.cols.values())
    for r in wire.refs.values():
        if r is None:
            n += 1
        elif isinstance(r, dict):
            n += int(np.asarray(r["uniform"]).nbytes)
        else:
            n += sum(int(np.asarray(x).nbytes) for x in r)
    return n
