"""The port's wire format (``rrtmg_lw_torch.parallel.wire``) against the
JAX package's (``rrtmg_lw_tpu.parallel.wire``), on the CPU.

* The encoders, numpy and C++ (``rrtmg_lw_torch.native``, built from
  ``native/wirecodec.cc`` into the port's build directory), give JAX's
  numpy encoders' codes and refs bitwise: auto schema, ``"coded"``, a
  pinned schema, ``frozen`` refs, and the same ``ValueError``s on the
  frozen guardrails and schema violations.
* The decoders (the plain twin of K9, what the CPU runs) equal JAX's on
  the same WireBatch: within 1e-14 relative in float64 and 2 ulps in
  float32 (``exp`` of two libraries), zero sentinels and every other
  codec exact, and the ``ok`` flags identical on each corruption case of
  tests/test_wire.py:434-526.
* ``validate_wire`` raises on the same truncations; a shard saved by
  either package loads in the other with equal arrays; ``wire_bytes``
  is equal.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu.parallel import wire as jw
from rrtmg_lw_tpu.utils import synthetic as jsyn

from rrtmg_lw_torch import native
from rrtmg_lw_torch.parallel import wire as tw
from rrtmg_lw_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

B, L = 24, 9


def _numpy_encoder(fn, *a, **kw):
    """``fn`` with the numpy encoders (RRTMG_WIRE_NATIVE=0)."""
    old = os.environ.get("RRTMG_WIRE_NATIVE")
    os.environ["RRTMG_WIRE_NATIVE"] = "0"
    try:
        return fn(*a, **kw)
    finally:
        if old is None:
            del os.environ["RRTMG_WIRE_NATIVE"]
        else:
            os.environ["RRTMG_WIRE_NATIVE"] = old


def _host(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _same_wire(a, b):
    """Two WireBatch / CompactCloudsWire (of either package) hold equal
    arrays, bitwise, in the same structure."""
    if hasattr(a, "mask_bits"):
        assert np.array_equal(_host(a.mask_bits), _host(b.mask_bits))
        a, b = a.fields, b.fields
    assert set(a.cols) == set(b.cols)
    for k in a.cols:
        x, y = _host(a.cols[k]), _host(b.cols[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert set(a.refs) == set(b.refs)
    for k, ra in a.refs.items():
        rb = b.refs[k]
        if ra is None:
            assert rb is None, k
        elif isinstance(ra, dict):
            assert np.array_equal(_host(ra["uniform"]), _host(rb["uniform"]))
        else:
            assert len(ra) == len(rb), k
            for x, y in zip(ra, rb):
                x, y = _host(x), _host(y)
                assert x.dtype == y.dtype, k
                assert np.array_equal(x, y, equal_nan=True), k


@pytest.fixture(scope="module")
def atm():
    return jsyn.make_atmosphere(ncol=B, nlay=L, dtype=jnp.float32)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def test_cpp_encoder_builds_in_the_port():
    assert native.wire_native_available()
    so = native._library()._name
    assert "build/rrtmg_lw_torch" in so and not so.endswith(
        "native/libwirecodec.so")


@pytest.mark.parametrize("native_enc", [False, True])
@pytest.mark.parametrize("schema", [None, "coded", "pinned"])
def test_encoders_equal_jax(atm, native_enc, schema):
    a = _np(atm)
    a["covmr"] = np.zeros_like(a["covmr"])          # a zero channel
    cp = jsyn.make_cloud_profile_fields(B, L, seed=3)
    sch_a = sch_c = schema
    if schema == "pinned":
        sch_a = jw.schema_of(_numpy_encoder(jw.encode_atmosphere, a))
        sch_c = jw.schema_of(_numpy_encoder(jw.encode_cloud_profiles, cp))
    port = (lambda f, *x, **k: f(*x, **k)) if native_enc else _numpy_encoder
    _same_wire(port(tw.encode_atmosphere, a, schema=sch_a),
               _numpy_encoder(jw.encode_atmosphere, a, schema=sch_a))
    _same_wire(port(tw.encode_cloud_profiles, cp, schema=sch_c),
               _numpy_encoder(jw.encode_cloud_profiles, cp, schema=sch_c))
    clouds = jsyn.make_mcica_clouds(ncol=B, nlay=L, dtype=jnp.float32,
                                    layout="compact")
    _same_wire(port(tw.encode_compact_clouds, tsyn.make_mcica_clouds(
        B, L, dtype=np.float32, layout="compact")),
        _numpy_encoder(jw.encode_compact_clouds, clouds))


def test_cpp_encoder_equals_numpy_on_hard_inputs():
    """tests/test_wire.py's native-parity inputs: zero holes in a
    lognormal field, temperatures, a 1-D channel."""
    rng = np.random.default_rng(5)
    pos = np.abs(rng.lognormal(0.0, 1.5, (33, 17)))
    pos[rng.random((33, 17)) < 0.2] = 0.0
    temps = 250.0 + 40.0 * rng.random((34, 12))
    for enc, x in ((tw._enc_logratio, pos), (tw._enc_delta, temps),
                   (tw._enc_delta, temps[:, 0])):
        u_np, r_np = _numpy_encoder(enc, x)
        u_nat, r_nat = enc(x)
        assert np.array_equal(u_np, u_nat)
        for a, b in zip(r_np, r_nat):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_frozen_refs_equal_jax(atm):
    a = _np(atm)
    del a["tauaer"]
    base = tw.encode_atmosphere(a, schema="coded")
    jbase = jw.encode_atmosphere(a, schema="coded")
    _same_wire(base, jbase)
    half = {k: v[:B // 2] for k, v in a.items()}
    hot = dict(a, tlay=a["tlay"] + 500.0)          # saturates at the edge
    for x in (half, hot):
        _same_wire(tw.encode_atmosphere(x, refs=base.refs),
                   jw.encode_atmosphere(x, refs=jbase.refs))


def test_frozen_guardrails_raise_as_jax(atm):
    a = _np(atm)
    cp = jsyn.make_cloud_profile_fields(B, L)
    cp2 = dict(cp, rei=cp["rei"] + np.linspace(0, 5, B)[:, None].astype(
        np.float32))
    clear = {k: (np.zeros_like(v) if k in ("cldfrac", "ciwp", "clwp")
                 else v) for k, v in cp.items()}
    for pkg in (tw, jw):
        with pytest.raises(ValueError, match="no coded reference"):
            pkg.encode_atmosphere(a, schema="coded",
                                  refs=pkg.encode_atmosphere(a).refs)
        with pytest.raises(ValueError, match="zero range"):
            pkg.encode_cloud_profiles(cp2, refs=pkg.encode_cloud_profiles(
                cp, schema="coded").refs)
        with pytest.raises(ValueError, match="schema violation"):
            pkg.encode_cloud_profiles(cp, schema=pkg.schema_of(
                pkg.encode_cloud_profiles(clear)))


def _ulps32(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    m = np.maximum(np.abs(a), np.abs(b))
    return float(np.max(np.abs(a.astype(np.float64) - b) / np.spacing(m),
                        initial=0.0))


def _close(got, ref, dtype, what):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    assert np.array_equal(got == 0, ref == 0), what
    if dtype == "float32":
        assert _ulps32(got, ref) <= 2, (what, _ulps32(got, ref))
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0, err_msg=what)


def _corrupt(enc, name, which):
    ref, lo, hi = enc.refs[name]
    bad = {"nan_ref": (np.full_like(np.asarray(ref), np.nan), lo, hi),
           "inf_lo": (ref, np.float32(-np.inf), hi),
           "nan_hi": (ref, lo, np.float32(np.nan)),
           "inverted": (ref, hi, lo)}[which]
    refs = dict(enc.refs)
    refs[name] = bad
    return type(enc)(dict(enc.cols), refs)


def _atm_cases(atm):
    """(tag, WireBatch) of the port's class: clean (coded and auto), and
    the corruptions of tests/test_wire.py:434-526."""
    a = _np(atm)
    a["cfc11vmr"] = np.zeros_like(a["cfc11vmr"])
    auto = tw.encode_atmosphere(a)
    coded = tw.encode_atmosphere(a, schema="coded")
    cases = [("auto", auto), ("coded", coded)]
    cases += [(w, _corrupt(coded, "play", w))
              for w in ("nan_ref", "inf_lo", "nan_hi", "inverted")]
    cases.append(("tlay_nan_ref", _corrupt(coded, "tlay", "nan_ref")))
    cols = dict(coded.cols)
    play = np.array(cols["play"])
    play[: B // 2] = 0                  # exact-zero sentinel: 0 hPa
    cols["play"] = play
    cases.append(("zero_play", tw.WireBatch(cols, dict(coded.refs))))
    refs = dict(auto.refs)
    row = np.array(refs["co2vmr"]["uniform"])
    row[2] = np.inf
    refs["co2vmr"] = {"uniform": row}
    cases.append(("inf_uniform", tw.WireBatch(dict(auto.cols), refs)))
    return cases


def _as_jax(enc):
    """The same arrays in the JAX package's WireBatch."""
    return jw.WireBatch(dict(enc.cols), dict(enc.refs))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_atmosphere_decode_equals_jax(atm, dtype):
    tauaer = np.asarray(atm.tauaer)
    for tag, enc in _atm_cases(atm):
        for sanitize in ((False, True) if tag in ("auto", "coded")
                         else (True,)):
            got = tw.decode_atmosphere(enc, torch.from_numpy(tauaer),
                                       getattr(torch, dtype),
                                       sanitize=sanitize)
            ref = jax.jit(lambda e, t: jw.decode_atmosphere(
                e, t, getattr(jnp, dtype), sanitize=sanitize))(
                    _as_jax(enc), jnp.asarray(tauaer))
            if sanitize:
                (got, ok), (ref, rok) = got, ref
                assert np.array_equal(ok.numpy(), np.asarray(rok)), tag
                assert tag in ("auto", "coded") or not ok.all(), tag
            for name in jw.ATM_FIELDS:
                _close(getattr(got, name), getattr(ref, name), dtype,
                       (tag, name, sanitize))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cloud_decodes_equal_jax(dtype):
    cp = jsyn.make_cloud_profile_fields(B, L, seed=5)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    enc = tw.encode_cloud_profiles(cp, schema="coded")
    for tag, e in (("clean", enc), ("ciwp_nan_hi",
                                    _corrupt(enc, "ciwp", "nan_hi"))):
        got, ok = tw.decode_cloud_profiles(e, tdt, sanitize=True)
        ref, rok = jax.jit(lambda x: jw.decode_cloud_profiles(
            x, jdt, sanitize=True))(_as_jax(e))
        assert np.array_equal(ok.numpy(), np.asarray(rok)), tag
        for name in jw.CLOUD_FIELDS:
            _close(got[name], ref[name], dtype, (tag, name))
    # a clear batch under auto schema: no codes, the shape from like
    clear = {k: (np.zeros_like(v) if k in ("cldfrac", "ciwp", "clwp")
                 else v) for k, v in cp.items()}
    e = tw.encode_cloud_profiles(clear)
    with pytest.raises(ValueError, match="like"):
        tw.decode_cloud_profiles(e)
    got = tw.decode_cloud_profiles(e, tdt, like=torch.zeros(B, L))
    ref = jw.decode_cloud_profiles(_as_jax(e), jdt, like=cp["cldfrac"])
    for name in jw.CLOUD_FIELDS:
        _close(got[name], ref[name], dtype, name)
    # compact clouds on the wire: the mask bitwise, the fields as above
    clouds = tsyn.make_mcica_clouds(B, L, seed=6, dtype=np.float32,
                                    mask_dtype=np.int8)
    cw = tw.encode_compact_clouds(clouds)
    refs = dict(cw.fields.refs)
    ref_, lo, hi = refs["clwp"]
    refs["clwp"] = (np.full_like(np.asarray(ref_), np.inf), lo, hi)
    bad = tw.CompactCloudsWire(cw.mask_bits, tw.WireBatch(
        dict(cw.fields.cols), refs))
    for e in (cw, bad):
        got, ok = tw.decode_compact_clouds(e, tdt, sanitize=True)
        ref, rok = jw.decode_compact_clouds(
            jw.CompactCloudsWire(e.mask_bits, _as_jax(e.fields)), jdt,
            mask_dtype=jnp.int8, sanitize=True)
        assert np.array_equal(ok.numpy(), np.asarray(rok))
        assert np.array_equal(got.cldfmc.numpy(), np.asarray(ref.cldfmc))
        assert np.array_equal(got.cldfmc.numpy(), clouds.cldfmc)
        for name in ("ciwp", "clwp", "reicmc", "relqmc"):
            _close(getattr(got, name), getattr(ref, name), dtype, name)


def test_validate_wire_raises_as_jax(atm):
    enc = tw.encode_atmosphere(_np(atm))
    assert tw.validate_wire(enc) == jw.validate_wire(_as_jax(enc)) == B
    cols = dict(enc.cols)
    cols["tlay"] = np.asarray(cols["tlay"])[: B // 2]
    refs = dict(enc.refs)
    del refs["play"]
    cols2 = dict(enc.cols)
    del cols2["play"]
    cols3 = dict(enc.cols)
    cols3["play"] = np.asarray(cols3["play"]).astype(np.uint8)
    refs4 = dict(enc.refs)
    refs4["play"] = refs4["play"][:2]
    cols5, refs5 = dict(enc.cols), dict(enc.refs)
    cols5["bogus"], refs5["bogus"] = cols5["play"], refs5["play"]
    for (cols_, refs_), match in (
            ((cols, enc.refs), "batch dim"), ((enc.cols, refs), "no refs"),
            ((cols2, enc.refs), "codes are missing"),
            ((cols3, enc.refs), "uint16"), ((enc.cols, refs4), "arity"),
            ((cols5, refs5), "unknown channel")):
        for pkg in (tw, jw):
            with pytest.raises(ValueError, match=match):
                pkg.validate_wire(pkg.WireBatch(dict(cols_), dict(refs_)))
    cw = tw.encode_compact_clouds(tsyn.make_mcica_clouds(B, L))
    assert tw.validate_wire(cw) == B
    for pkg in (tw, jw):
        with pytest.raises(ValueError, match="batch dim"):
            pkg.validate_wire(pkg.CompactCloudsWire(
                np.asarray(cw.mask_bits)[:, :, : B // 2],
                pkg.WireBatch(cw.fields.cols, cw.fields.refs)))


def test_shards_move_between_packages(atm, tmp_path):
    a = _np(atm)
    a["covmr"] = np.zeros_like(a["covmr"])
    cp = jsyn.make_cloud_profile_fields(B, L)
    shards = [tw.encode_atmosphere(a),
              tw.encode_cloud_profiles(cp, schema="coded"),
              tw.encode_compact_clouds(tsyn.make_mcica_clouds(B, L))]
    for i, enc in enumerate(shards):
        tw.save_wire(tmp_path / f"t{i}.npz", enc)
        jl = jw.load_wire(tmp_path / f"t{i}.npz")
        _same_wire(jl, enc)
        jw.save_wire(tmp_path / f"j{i}.npz", jl)
        _same_wire(tw.load_wire(tmp_path / f"j{i}.npz"), enc)
        assert type(tw.load_wire(tmp_path / f"j{i}.npz")).__module__ == \
            tw.__name__
        assert (tmp_path / f"t{i}.npz").read_bytes() == \
            (tmp_path / f"j{i}.npz").read_bytes()
        assert tw.wire_bytes(enc) == jw.wire_bytes(jl)
