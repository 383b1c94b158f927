"""Gradients through the random-overlap sweep modes and the effective
radii on the CPU, against the JAX package.

(a) The banded gradient step (BandClouds, icld=1, inflag 2 / iceflag 3 /
    liqflag 1): ``make_grad_step`` of ``impl="eager"`` and of
    ``impl="cuda"`` (the kernels' autograd Functions, whose backward on
    the CPU is the plain vjp: of K6 banded, ``rtrn.rt_sweep_banded_vjp``,
    and of K4b) against ``jax.value_and_grad`` of the JAX model (XLA
    engines), w.r.t. every Atmosphere field and the clouds' cldfrac,
    ciwp, clwp, reic and relq.
(b) The same for McICA per-g clouds (``McicaCloudsBlocked``): inflag=2
    (K1 fused, cldprmc inline) w.r.t. every field, inflag=0 (K1
    cldf-odcld) w.r.t. cldfmc and taucmc; and the compact McICA path
    (K1 compact) w.r.t. the radii, which reach it through K4.
(c) K4b's plain vjp (``cldcoef_cuda.ice_liq_coeffs_vjp`` on CPU tensors)
    against ``jax.vjp`` of the JAX ``_ice_liq_coeffs``, on radii below,
    inside, on the grid points of and above the tables.
(d) The banded plain sweep's radiances (``rt_sweep_banded(...,
    radiances=True)``, what K6 banded reads from K1) summed with the
    flux weights are its flux rows.

Tolerances: 1e-12 relative on the loss, 1e-10 of max |JAX| per field
(float64; the two packages sum in other orders), each cloud gradient
nonzero somewhere; (c) 1e-13; (d) 1e-13 relative.  The clouds of (b)
hold cloudy g-points without water and with an input cloud od below
cldprmc's CLDMIN, where inflag=2 reads taucmc, so that every field has a
gradient; the radii vary inside the tables.  One ``jax.value_and_grad``
compile per configuration (``lru_cache``), at (B, L) = (4, 12).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
from rrtmg_lw_tpu.ops import cldprop as jcldprop
from rrtmg_lw_tpu import types as jtypes

from rrtmg_lw_torch import (Atmosphere, BandClouds, LWConfig,
                            McicaCloudsBlocked, McicaCloudsCompact,
                            make_model)
from rrtmg_lw_torch.data.ktables import tables_from_numpy
from rrtmg_lw_torch.ops import cldprop, rtrn, setcoef
from rrtmg_lw_torch.ops.cldcoef_cuda import ice_liq_coeffs_vjp
from rrtmg_lw_torch.ops.inatm import inatm
from rrtmg_lw_torch.parallel import (CLOUD_GRADS, MCICA_GRADS, RADII_GRADS,
                                     make_grad_step)
from rrtmg_lw_torch.utils import synthetic as tsyn
from test_torch_grad import noisy_atmosphere, rel_err
from test_torch_model import band_clouds

torch.set_num_threads(1)

SHAPE = (4, 12)
CFLAGS = dict(iceflag=3, liqflag=1, use_lut=False)


def radii(B, L, seed=3):
    """Effective radii varying inside the tables (ice 10-100 um, liquid
    3-40 um)."""
    rng = np.random.default_rng(seed)
    return (10.0 + 90.0 * rng.random((B, L)), 3.0 + 37.0 * rng.random((B, L)))


def mcica_blocked(B, L, seed=5):
    """McicaCloudsBlocked numpy arrays (L, 144, B), pad rows zero: cloud
    fractions 0, in (0, 0.5) or in [0.5, 1) a third each; water where
    cloudy, no ice at a fifth of the cloudy g-points, and no water at a
    tenth, with an input cloud od there below cldprmc's CLDMIN (inflag=2
    reads taucmc only there) and of a few tenths elsewhere (inflag=0)."""
    rng = np.random.default_rng(seed)
    shape = (L, 144, B)
    u = rng.random(shape)
    cf = np.where(u < 1 / 3, 0.0, np.where(
        u < 2 / 3, 0.01 + 0.48 * rng.random(shape),
        0.5 + 0.5 * rng.random(shape)))
    cf[:, 140:] = 0.0
    u = rng.random(shape)
    ci = np.where((cf > 0) & (u > 0.2), 5.0 * rng.random(shape), 0.0)
    cl = np.where((cf > 0) & (u > 0.1), 20.0 + 20.0 * rng.random(shape), 0.0)
    tc = np.where(u > 0.1, cf * (0.05 * ci + 0.1 * cl), 5e-21 * cf)
    reic, relq = radii(B, L, seed)
    return McicaCloudsBlocked(cf, ci, cl, tc, reic, relq)


@functools.lru_cache(maxsize=None)
def _jax(kind):
    """The JAX model's default loss on noisy_atmosphere and the clouds of
    ``kind`` (``CASES``), its gradient w.r.t. every Atmosphere field and
    the kind's cloud fields: -> (model, atmosphere, clouds (numpy), the
    fields, the config, loss, Atmosphere grads, cloud grads)."""
    B, L = SHAPE
    cfg, clouds, fields, jtype = CASES[kind]()
    jm = jmake_model(JConfig(taumol_impl="xla", rt_impl="xla", **CFLAGS,
                             **cfg))
    natm = noisy_atmosphere(B, L)

    def jloss(a, cw):
        fl = jm(a, jtype(*(jnp.asarray(x) for x in clouds))._replace(**cw))
        return (fl.hr ** 2).mean() + (fl.uflx[:, -1] ** 2).mean()

    cw = {k: jnp.asarray(getattr(clouds, k)) for k in fields}
    jl, (ja, jc) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, natm), cw)
    return jm, natm, clouds, fields, cfg, float(jl), ja, jc


def _banded():
    B, L = SHAPE
    reic, relq = radii(B, L)
    return (dict(icld=1, imca=0, inflag=2),
            band_clouds(B, L)._replace(reic=reic, relq=relq),
            CLOUD_GRADS + RADII_GRADS, jtypes.BandClouds)


def _fused():
    return (dict(icld=2, imca=1, inflag=2), mcica_blocked(*SHAPE),
            MCICA_GRADS, jtypes.McicaCloudsBlocked)


def _cldf_od():
    return (dict(icld=2, imca=1, inflag=0), mcica_blocked(*SHAPE),
            ("cldfmc", "taucmc"), jtypes.McicaCloudsBlocked)


def _compact():
    B, L = SHAPE
    reic, relq = radii(B, L)
    c = tsyn.make_mcica_clouds(B, L, mask_dtype=np.int8)
    return (dict(icld=2, imca=1, inflag=2),
            c._replace(reicmc=reic, relqmc=relq),
            ("ciwp", "clwp") + ("reicmc", "relqmc"),
            jtypes.McicaCloudsCompact)


CASES = {"banded": _banded, "fused": _fused, "cldf_od": _cldf_od,
         "compact": _compact}
TYPES = {"banded": BandClouds, "fused": McicaCloudsBlocked,
         "cldf_od": McicaCloudsBlocked, "compact": McicaCloudsCompact}


@functools.lru_cache(maxsize=None)
def _steps(kind):
    """Both impls' ``make_grad_step`` results (the default loss, w.r.t.
    the Atmosphere and the kind's cloud fields), on the JAX model's
    tables: -> the JAX results and {impl: (loss, grads, cloud grads)}."""
    jm, natm, clouds, fields, cfg, jl, ja, jc = _jax(kind)
    tables = tables_from_numpy(jm.ktables, jm.static_np, device="cpu")
    atm = Atmosphere.from_numpy(natm, "cpu")
    cl = TYPES[kind].from_numpy(clouds, "cpu")
    out = {}
    for impl in ("eager", "cuda"):
        model = make_model(LWConfig(**CFLAGS, **cfg), device="cpu",
                           tables=tables)
        model.impl = impl          # "cuda": the Functions, on the CPU
        out[impl] = make_grad_step(model, cloud_fields=fields)(atm, cl)
    return (jl, ja, jc, fields), out


@pytest.mark.parametrize("kind", ["banded", "fused", "cldf_od"])
def test_grad_step_matches_jax_value_and_grad(kind):
    """The loss and every Atmosphere field's gradient of the banded,
    fused and cldf-odcld steps against jax.value_and_grad."""
    (jl, ja, _, _), out = _steps(kind)
    for impl, (loss, g, _) in out.items():
        assert abs(float(loss) - jl) <= 1e-12 * abs(jl), impl
        for name in Atmosphere._fields:
            assert rel_err(getattr(g, name), getattr(ja, name)) <= 1e-10, \
                (impl, name)


@pytest.mark.parametrize("kind", ["banded", "fused", "cldf_od", "compact"])
def test_cloud_grads_match_jax(kind):
    """The default loss's gradients w.r.t. the clouds' fields against
    jax.grad w.r.t. the JAX clouds: banded cldfrac, ciwp, clwp, reic,
    relq; fused every McicaCloudsBlocked field; cldf-odcld cldfmc and
    taucmc; compact McICA the water paths and the radii."""
    (_, _, jc, fields), out = _steps(kind)
    for impl, (_, _, got) in out.items():
        for name, gc in zip(fields, got):
            assert bool((gc != 0).any()), (impl, name)
            assert rel_err(gc, jc[name]) <= 1e-10, (impl, name)


@pytest.mark.parametrize("iceflag", [2, 3])
def test_ice_liq_coeffs_vjp_matches_jax_vjp(iceflag):
    """K4b's plain vjp against jax.vjp of _ice_liq_coeffs: radii below the
    tables, inside, exactly on their grid points (reic = 2 + 3k, relq =
    1.5 + k) and above them; the integer index clamps carry no gradient,
    and past the ends the slope is the clamped interval's."""
    B, L = 7, 9
    rng = np.random.default_rng(iceflag)
    k = rng.integers(0, 60, (B, L))
    reic = np.where(rng.random((B, L)) < 0.5, 160.0 * rng.random((B, L)),
                    2.0 + 3.0 * k)
    relq = np.where(rng.random((B, L)) < 0.5, 70.0 * rng.random((B, L)),
                    1.5 + k)
    reic[0, :4] = (0.5, 2.0, 200.0, 140.0)
    relq[0, :4] = (0.5, 1.5, 90.0, 60.0)
    ct_i, ct_l = (rng.standard_normal((B, L, 16)) for _ in range(2))
    jm = jmake_model(JConfig(icld=2, use_lut=False, taumol_impl="xla",
                             rt_impl="xla"))
    _, vjp = jax.vjp(lambda r, q: jcldprop._ice_liq_coeffs(
        r, q, iceflag, 1, jm.static, jnp.float64)[:2], jnp.asarray(reic),
        jnp.asarray(relq))
    j_reic, j_relq = vjp((jnp.asarray(ct_i), jnp.asarray(ct_l)))
    tables = tables_from_numpy(jm.ktables, jm.static_np, device="cpu")
    static = make_model(LWConfig(use_lut=False), device="cpu",
                        tables=tables).static_tensors()
    got = ice_liq_coeffs_vjp(
        torch.as_tensor(reic), torch.as_tensor(relq), iceflag, 1, static,
        *(torch.as_tensor(c).permute(1, 2, 0).contiguous()
          for c in (ct_i, ct_l)))
    for g, r in zip(got, (j_reic, j_relq)):
        assert bool((g != 0).any())
        assert rel_err(g, r) <= 1e-13


def test_banded_radiances_sum_to_the_fluxes():
    """The banded plain sweep's radiances (D, U and their clear twins at
    levels 0..L-1, what K6 banded reads) weighted by wg and summed over g
    are its down, up, clear down and clear up flux rows; the fluxes are
    the sweep's without radiances."""
    B, L = 5, 9
    model = make_model(LWConfig(icld=1, imca=0, use_lut=False),
                       device="cpu")
    static = model.static_tensors()
    prof = inatm(Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu"))
    sc = setcoef.setcoef(prof, static, planck=False)
    tg, fr = model.engine.blocked(sc, prof)
    play, plev = (setcoef.interp_planck_blocked(t.t().contiguous(),
                                                model.totplnk)
                  for t in (prof.tavel, prof.tz))
    bc = BandClouds.from_numpy(band_clouds(B, L), "cpu")
    taucb, _ = cldprop.cldprop_banded_blocked(bc, static, inflag=2,
                                              iceflag=3, liqflag=1)
    surf = rtrn.surf_rows(sc.plankbnd, prof.semiss, prof.pwvcm, tg.dtype)
    a = (tg, fr, play, plev, surf, bc.cldfrac.t().contiguous(), taucb,
         model.ngb0, model.wg)
    fl, rads = rtrn.rt_sweep_banded(*a, radiances=True)
    assert torch.equal(fl, rtrn.rt_sweep_banded(*a))
    assert rads.shape == (4, L, 140, B)
    flux = torch.einsum("rlgb,g->rlb", rads, model.wg)
    for r, f in ((0, 1), (1, 0), (2, 3), (3, 2)):
        np.testing.assert_allclose(flux[r].numpy(), fl[f, :L].numpy(),
                                   rtol=1e-13, atol=1e-9)
    # the clouds change the total-sky radiances, not the clear ones
    # below the highest cloud
    assert not torch.equal(rads[0], rads[2])
