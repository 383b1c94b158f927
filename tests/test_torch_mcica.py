"""The port's McICA sub-column generator (``rrtmg_lw_torch.ops.mcica``,
the plain version of K8) against the JAX package's, on the CPU.

* Bitwise: JAX draws its uniforms inside the generator
  (``jax.random.uniform`` of the key, split in two for icld 4/5, in the
  function's own layout); the same uniforms, given to the port's overlap
  core (``uniforms=``, the batch layout's permuted (B, L, G) -> (L, G,
  B)), give the same masks exactly, and the same per-g water paths and
  cloud od, for icld 1-5, float32 and float64, int8 and float masks.
* ``get_alpha`` within 1e-12 in float64 on every branch; the reference
  generators (MT19937, KISS, the single-column generator) bitwise.
* The port's own draw, Philox4x32-10: Random123's known answers, the same
  key giving the same draw and ``fold_in`` steps different ones; the
  statistics of its masks (per-layer cloudy fraction, pairwise overlap,
  the binomial envelope) with the expected values and tolerances of
  tests/test_mcica.py.
* The generate-then-radiate step: JAX's generator then the JAX model,
  against the port's generator fed the same uniforms then the port's
  model, float64, the fluxes within 1e-12 W/m2 and the heating rates
  within 1e-12 W/m2 of the flux divergence they stand for (|d hr| dp /
  heatfac: in K/day the thin top layers amplify a float64 rounding of the
  fluxes to ~1e-11).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
from rrtmg_lw_tpu.data import ktables as jkt
from rrtmg_lw_tpu.ops import mcica as jm
from rrtmg_lw_tpu.types import McicaCloudsCompact as JCompact
from rrtmg_lw_tpu.utils import synthetic as jsyn

from rrtmg_lw_torch import Atmosphere, LWConfig, make_model
from rrtmg_lw_torch.constants import heatfac
from rrtmg_lw_torch.data.ktables import tables_from_numpy
from rrtmg_lw_torch.ops import mcica as tm
from rrtmg_lw_torch.ops import mcica_cuda
from rrtmg_lw_torch.types import McicaClouds, McicaCloudsCompact
from rrtmg_lw_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

G = 140
NGB = jkt.load_static()["ngb"]


def _state(B, L, dtype, seed=0):
    """Cloud state (B, L) exercising every branch of the overlap walk:
    clear, overcast and partial layers, values below CLDMIN, runs of
    cloud and gaps; alpha in [0, 1]; per-band tauc (B, L, 16)."""
    rng = np.random.default_rng(seed)
    cf = rng.random((B, L)) * (rng.random((B, L)) < 0.6)
    cf[rng.random((B, L)) < 0.1] = 1.0
    cf[rng.random((B, L)) < 0.05] = 1e-25
    cf[::5] = 0.0
    out = dict(cldfrac=cf, ciwp=np.where(cf > 0, 5 + rng.random((B, L)), 0),
               clwp=np.where(cf > 0, 20 + rng.random((B, L)), 0),
               rei=np.full((B, L), 30.0), rel=np.full((B, L), 10.0),
               tauc=rng.random((B, L, 16)), alpha=rng.random((B, L)))
    return {k: v.astype(dtype) for k, v in out.items()}


def _jax_uniforms(key, icld, shape, dtype, layer_axis):
    """The uniforms JAX's generator draws inside, in its layout."""
    if icld in (4, 5):
        k1, k2 = jax.random.split(key)
        return (jax.random.uniform(k1, shape, dtype),
                jax.random.uniform(k2, shape, dtype))
    if icld == 3:
        shape = tuple(1 if i == layer_axis else n
                      for i, n in enumerate(shape))
    return jax.random.uniform(key, shape, dtype), None


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("icld", [1, 2, 3, 4, 5])
def test_compact_masks_equal_jax_on_its_uniforms(icld, dtype):
    B, L = 24, 9
    s = _state(B, L, dtype, seed=icld)
    key = jax.random.PRNGKey(icld)
    u, u2 = _jax_uniforms(key, icld, (L, G, B), dtype, 0)
    args = [s[k] for k in ("cldfrac", "ciwp", "clwp", "rei", "rel")]
    for jmask, tmask in ((None, None), (np.int8, torch.int8)):
        ref = jm.mcica_subcol_lw_compact(key, icld, *map(jnp.asarray, args),
                                         alpha=jnp.asarray(s["alpha"]),
                                         mask_dtype=jmask)
        got = tm.mcica_subcol_lw_compact(
            None, icld, *map(torch.from_numpy, args),
            alpha=torch.from_numpy(s["alpha"]), mask_dtype=tmask,
            uniforms=(_t(u), _t(u2)))
        assert isinstance(got, McicaCloudsCompact)
        want = np.asarray(ref.cldfmc)
        assert got.cldfmc.shape == (L, 144, B)
        assert str(want.dtype) == str(got.cldfmc.dtype).split(".")[1]
        np.testing.assert_array_equal(got.cldfmc.numpy(), want)
        assert not got.cldfmc[:, G:].any()
        assert 0 < float(got.cldfmc.double().mean()) < 1
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("icld", [1, 2, 3, 4, 5])
def test_batch_layout_equals_jax_on_its_uniforms(icld, dtype):
    B, L = 16, 7
    s = _state(B, L, dtype, seed=10 + icld)
    key = jax.random.PRNGKey(100 + icld)
    u, u2 = _jax_uniforms(key, icld, (B, L, G), dtype, 1)
    perm = [np.asarray(x).transpose(1, 2, 0) if x is not None else None
            for x in (u, u2)]
    names = ("cldfrac", "ciwp", "clwp", "rei", "rel", "tauc")
    ref = jm.mcica_subcol_lw(key, icld, *(jnp.asarray(s[k]) for k in names),
                             alpha=jnp.asarray(s["alpha"]), ngb=NGB)
    got = tm.mcica_subcol_lw(None, icld,
                             *(torch.from_numpy(s[k]) for k in names),
                             alpha=torch.from_numpy(s["alpha"]), ngb=NGB,
                             uniforms=tuple(map(_t, perm)))
    assert isinstance(got, McicaClouds)
    for name, a, b in zip(McicaClouds._fields, got, ref):
        assert a.dtype == getattr(torch, dtype), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert 0 < float(got.cldfmc.mean()) < 1
    assert float(got.taucmc.abs().sum()) > 0


GET_ALPHA_CASES = [
    dict(icld=4), dict(icld=5), dict(icld=4, decorr_con=0.0),
    dict(icld=4, decorr_con=-3.0), dict(icld=2),
    dict(icld=4, idcor=1, juldat=100), dict(icld=5, idcor=1, juldat=181),
    dict(icld=4, idcor=1, juldat=182), dict(icld=5, idcor=1, juldat=300)]


@pytest.mark.parametrize("case", GET_ALPHA_CASES,
                         ids=lambda c: "-".join(f"{k}{v}"
                                                for k, v in c.items()))
def test_get_alpha_matches_jax(case):
    B, L = 6, 12
    rng = np.random.default_rng(5)
    dz = 200.0 + 800.0 * rng.random((B, L))
    cf = rng.random((B, L)) * (rng.random((B, L)) < 0.5)
    lat = np.array([-80.0, -30.0, 0.0, 12.5, 45.0, 89.0])
    kw = dict(case, cldfrac=cf)
    if case.get("idcor"):
        kw["lat"] = lat
    ref = np.asarray(jm.get_alpha(jnp.asarray(dz), **dict(
        kw, cldfrac=jnp.asarray(cf))))
    got = tm.get_alpha(torch.from_numpy(dz), **dict(
        kw, cldfrac=torch.from_numpy(cf)))
    assert got.dtype == torch.float64 and got.shape == (B, L)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    if case["icld"] in (4, 5):
        # a zero decorrelation length decorrelates every layer
        assert (got[:, 0] == 0).all()
        assert (float(got.max()) > 0) == (case.get("decorr_con") != 0.0)


def test_mt19937_known_answer_and_stream():
    mt = tm.MersenneTwisterRef(5489)
    assert [int(mt.random_int32()) for _ in range(5)] == [
        3499211612, 581869302, 3890346734, 3586334585, 545404204]
    a, b = tm.MersenneTwisterRef(7), jm.MersenneTwisterRef(7)
    # across two regenerations of the state
    assert [a.random_real() for _ in range(1300)] == \
        [b.random_real() for _ in range(1300)]


def test_kissvec_matches_jax():
    pm = np.array([[101325.33, 95000.77, 90000.19, 85000.91],
                   [100000.5, 99000.25, 90000.125, 1.0]])
    a, b = tm.KissVecRef(pm), jm.KissVecRef(pm)
    for _ in range(200):
        np.testing.assert_array_equal(a.draw(), b.draw())
    with pytest.raises(ValueError):
        tm.KissVecRef(pm[:, ::-1])


@pytest.mark.parametrize("irng", [0, 1])
@pytest.mark.parametrize("icld", [1, 2, 3, 4, 5])
def test_reference_generator_matches_jax(icld, irng):
    L = 10
    rng = np.random.default_rng(icld)
    cldfrac = np.zeros(L)
    cldfrac[2:5] = 0.6
    cldfrac[6] = 0.3
    cldfrac[8] = 1e-30
    clwp = np.where(cldfrac > 0, 30.0, 0.0)
    ciwp = np.where(cldfrac > 0, 5.0, 0.0)
    pmid = 101325.33 * np.exp(-np.arange(L) / 7.0) + 0.123456
    tauc = rng.random((16, L))
    alpha = np.full(L, 0.8)
    alpha[0] = 0.0
    for seed in (1, 4):
        got = tm.generate_stochastic_clouds_ref(
            L, icld, irng, pmid, cldfrac, clwp, ciwp, alpha, tauc, seed,
            NGB)
        ref = jm.generate_stochastic_clouds_ref(
            L, icld, irng, pmid, cldfrac, clwp, ciwp, alpha, tauc, seed,
            NGB)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got["cldfmc"][:, 2:5].any()


def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32 with 10 rounds."""
    M = 0xFFFFFFFF
    kat = [((0, 0, 0, 0), (0, 0),
            (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
           ((M, M, M, M), (M, M),
            (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
           ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
            (0xa4093822, 0x299f31d0),
            (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, k, want in kat:
        assert tuple(int(w) for w in tm.philox4x32(ctr, k)) == want
    ctr = torch.tensor([c for c, _, _ in kat[:1]] * 3, dtype=torch.int64)
    ctr[1] = torch.tensor(kat[2][0]).to(torch.int64)
    ctr = (ctr - (ctr > 0x7FFFFFFF) * (1 << 32)).to(torch.int32)
    words = mcica_cuda.philox_words(ctr, kat[2][1])
    assert tuple(int(w) for w in words[1]) == kat[2][2]
    with pytest.raises(ValueError):
        mcica_cuda.philox_words(ctr, (0, 0), curand=True)


def test_philox_uniforms_keys_and_steps():
    for dtype in (torch.float32, torch.float64):
        k = tm.key(2024)
        a = tm.philox_uniforms(k, 9, 33, dtype)
        b = tm.philox_uniforms(k, 9, 33, dtype)
        assert a.shape == (9, G, 33) and a.dtype == dtype
        assert torch.equal(a, b)
        assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
        assert abs(float(a.mean()) - 0.5) < 0.01
        # a layer's uniform does not depend on how many layers are drawn
        assert torch.equal(tm.philox_uniforms(k, 3, 33, dtype), a[:3])
        c = tm.philox_uniforms(tm.fold_in(k, 1), 9, 33, dtype)
        d = tm.philox_uniforms(tm.fold_in(k, 2), 9, 33, dtype)
        e = tm.philox_uniforms(k, 9, 33, dtype, stream=tm.STREAM_U2)
        for x in (c, d, e):
            assert (x != a).float().mean() > 0.99
        assert (c != d).float().mean() > 0.99
    assert tm.key(5) != tm.key(6) and tm.fold_in(tm.key(5), 0) != tm.key(5)
    assert tm.fold_in(tm.key(5), 3) == tm.fold_in(tm.key(5), 3)
    with pytest.raises(ValueError):
        tm.key(-1)


def test_same_key_same_mask():
    s = _state(20, 8, "float32", seed=3)
    cf = torch.from_numpy(s["cldfrac"])
    al = torch.from_numpy(s["alpha"])
    for icld in (2, 4):
        a = tm.subcol_mask(tm.key(1), icld, cf, al, mask_dtype=torch.int8)
        b = mcica_cuda.subcol_mask(tm.key(1), icld, cf, al,
                                   mask_dtype=torch.int8)
        c = tm.subcol_mask(tm.fold_in(tm.key(1), 1), icld, cf, al,
                           mask_dtype=torch.int8)
        assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        tm.subcol_mask(tm.key(1), 6, cf)


def _stats_state(B, L):
    cldfrac = np.zeros((B, L))
    cldfrac[:, 4:8] = 0.6
    cldfrac[:, 12:14] = 0.3
    return cldfrac


@pytest.mark.parametrize("icld", [1, 2, 3, 4, 5])
def test_port_generator_statistics(icld):
    B, L = 64, 20
    cldfrac = _stats_state(B, L)
    clwp = np.where(cldfrac > 0, 30.0, 0.0)
    alpha = np.full((B, L), 0.8)
    alpha[:, 0] = 0.0
    t = torch.from_numpy
    out = tm.mcica_subcol_lw(
        tm.key(0), icld, t(cldfrac), t(np.zeros((B, L))), t(clwp),
        t(np.full((B, L), 30.0)), t(np.full((B, L), 10.0)),
        t(np.zeros((B, L, 16))), t(alpha))
    cldfmc = out.cldfmc.numpy()
    assert cldfmc.shape == (B, L, G)
    frac = cldfmc.mean(axis=(0, 2))
    np.testing.assert_allclose(frac[4:8], 0.6, atol=0.02)
    np.testing.assert_allclose(frac[12:14], 0.3, atol=0.02)
    assert frac[0] == 0.0 and frac[-1] == 0.0
    if icld == 3:
        deck = cldfmc[:, 4:8, :]
        assert np.all(deck == deck[:, :1, :])


@pytest.mark.parametrize("icld,within,across", [
    (1, 0.36, 0.36), (2, 0.60, 0.36), (3, 0.60, 0.60), (5, 0.552, None)])
def test_port_generator_pairwise_overlap(icld, within, across):
    B, L, c = 256, 9, 0.6
    cldfrac = np.zeros((B, L))
    cldfrac[:, 1:3] = c
    cldfrac[:, 5:7] = c
    zeros = np.zeros((B, L))
    t = torch.from_numpy
    out = tm.mcica_subcol_lw(
        tm.key(3), icld, t(cldfrac), t(zeros),
        t(np.where(cldfrac > 0, 30.0, 0.0)), t(np.full((B, L), 30.0)),
        t(np.full((B, L), 10.0)), t(np.zeros((B, L, 16))),
        t(np.full((B, L), 0.8)))
    m = out.cldfmc.numpy() > 0.5
    np.testing.assert_allclose((m[:, 1, :] & m[:, 2, :]).mean(), within,
                               atol=0.02)
    if across is not None:
        np.testing.assert_allclose((m[:, 2, :] & m[:, 5, :]).mean(), across,
                                   atol=0.02)


def test_port_compact_generator_statistics():
    B, L = 64, 12
    rng = np.random.default_rng(3)
    cf = np.clip(rng.random((B, L)), 0.05, 0.95)
    full = torch.full((B, L), 5.0, dtype=torch.float64)
    for icld in (1, 2, 3):
        cl = tm.mcica_subcol_lw_compact(tm.key(11), icld,
                                        torch.from_numpy(cf), full, full,
                                        full, full)
        assert cl.cldfmc.shape == (L, 144, B)
        assert not cl.cldfmc[:, G:].any()
        frac = cl.cldfmc[:, :G].numpy().mean(axis=1).T
        sig = np.sqrt(cf * (1 - cf) / G)
        assert (np.abs(frac - cf) < 4.5 * sig + 1e-9).mean() > 0.99
        if icld == 3:
            m = cl.cldfmc[:, :G].numpy()
            order = np.argsort(cf.T[:, None, :], axis=0)
            ms = np.take_along_axis(m, np.broadcast_to(order, m.shape),
                                    axis=0)
            assert (np.diff(ms, axis=0) >= 0).all()


def test_cloud_profile_fields_match_jax():
    a = tsyn.make_cloud_profile_fields(32, 20, seed=4)
    b = jsyn.make_cloud_profile_fields(32, 20, seed=4)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def _dz(atm):
    """Hypsometric layer thickness (m) of a synthetic atmosphere."""
    plev, tlay = np.asarray(atm.plev), np.asarray(atm.tlay)
    return 29.27 * tlay * np.log(plev[:, :-1] / plev[:, 1:])


@pytest.mark.parametrize("icld", [2, 4])
def test_generate_then_radiate_matches_jax(icld):
    """The slice end to end in float64: JAX's generator (compact int8
    mask) then the JAX model, against the port's generator fed the same
    uniforms then the port's model (icld, imca=1, use_lut=False)."""
    B, L = 6, 14
    atm = jsyn.make_atmosphere(B, L)
    f = {k: v.astype(np.float64)
         for k, v in jsyn.make_cloud_profile_fields(B, L, seed=2).items()}
    names = ("cldfrac", "ciwp", "clwp", "rei", "rel")
    alpha = tm.get_alpha(torch.from_numpy(_dz(atm)), icld)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    u, u2 = _jax_uniforms(key, icld, (L, G, B), "float64", 0)
    jc = jm.mcica_subcol_lw_compact(key, icld, *(jnp.asarray(f[k])
                                                for k in names),
                                    alpha=jnp.asarray(alpha.numpy()),
                                    mask_dtype=np.int8)
    assert isinstance(jc, JCompact)
    jmodel = jmake_model(JConfig(icld=icld, imca=1, use_lut=False,
                                 taumol_impl="xla", rt_impl="xla"))
    ref = jmodel(atm, jc)
    tc = tm.mcica_subcol_lw_compact(None, icld, *(torch.from_numpy(f[k])
                                                 for k in names),
                                    alpha=alpha, mask_dtype=torch.int8,
                                    uniforms=(_t(u), _t(u2)))
    np.testing.assert_array_equal(tc.cldfmc.numpy(), np.asarray(jc.cldfmc))
    model = make_model(LWConfig(icld=icld, imca=1, use_lut=False),
                       device="cpu", tables=tables_from_numpy(
                           jmodel.ktables, jmodel.static_np, device="cpu"))
    out = model(Atmosphere.from_numpy(atm, "cpu"), tc)
    for name in ("uflx", "dflx", "uflxc", "dflxc"):
        d = np.abs(getattr(out, name).numpy() - np.asarray(getattr(ref, name)))
        assert d.max() <= 1e-12, (name, d.max())
    # hr = heatfac * d(fnet) / dp: a rounding of the fluxes in float64 is
    # amplified by 1 / dp in the thin top layers (~1e-11 K/day there), so
    # the heating rates are held as the flux divergence they stand for
    dp = np.abs(np.diff(np.asarray(atm.plev), axis=1))
    for name in ("hr", "hrc"):
        d = np.abs(getattr(out, name).numpy()
                   - np.asarray(getattr(ref, name))) * dp / heatfac()
        assert d.max() <= 1e-12, (name, d.max())
    assert not torch.allclose(out.uflx, out.uflxc)
