"""The PyTorch port's whole forward step (the eager path, which runs the
plain versions of the four kernels) against the JAX model with its XLA
engines, on the same seeded numpy inputs: clear sky and McICA with
compact int8-mask clouds.

Tolerances: in float64, 1e-11 W/m2 on fluxes and 2e-9 K/day on heating
rates (measured here: ~1.2e-13 W/m2 and ~2.2e-11 K/day, the heating
difference coming from the thinnest top layers); the port in float32
against JAX in float64 holds the reference-accuracy bounds of
tests/test_f32_accuracy.py (< 5e-3 W/m2, < 0.05 K/day).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
from rrtmg_lw_tpu.utils import synthetic as jsyn

from rrtmg_lw_torch import (Atmosphere, LWConfig, McicaCloudsCompact,
                            make_model)
from rrtmg_lw_torch.data.ktables import tables_from_numpy
from rrtmg_lw_torch.ops.inatm import inatm
from rrtmg_lw_torch.utils import synthetic as tsyn

torch.set_num_threads(1)

FLUXES = ("uflx", "dflx", "uflxc", "dflxc")
HEATING = ("hr", "hrc")


def _inputs(B, L, icld, dtype):
    npdt = np.float32 if dtype == "float32" else np.float64
    atm = Atmosphere.from_numpy(tsyn.make_atmosphere(B, L, dtype=npdt),
                                "cpu", getattr(torch, dtype))
    clouds = McicaCloudsCompact.from_numpy(
        tsyn.make_mcica_clouds(B, L, dtype=npdt, mask_dtype=np.int8),
        "cpu", getattr(torch, dtype)) if icld else None
    return atm, clouds


def _jax(B, L, icld):
    jm = jmake_model(JConfig(icld=icld, imca=1, use_lut=False,
                             taumol_impl="xla", rt_impl="xla"))
    atm = jsyn.make_atmosphere(B, L)
    clouds = jsyn.make_mcica_clouds(B, L, layout="compact",
                                    mask_dtype=np.int8) if icld else None
    return jm, jm(atm, clouds)


def _max_diff(a, b, names):
    return max(float(np.abs(getattr(a, n).double().numpy()
                            - np.asarray(getattr(b, n))).max())
               for n in names)


@pytest.mark.parametrize("icld", [0, 2])
def test_model_matches_jax_f64(icld):
    B, L = 8, 20
    jm, ref = _jax(B, L, icld)
    model = make_model(LWConfig(icld=icld, imca=1, use_lut=False),
                       tables=tables_from_numpy(jm.ktables, jm.static_np))
    assert model.impl == "eager"
    out = model(*_inputs(B, L, icld, "float64"))
    for name in FLUXES + HEATING:
        assert getattr(out, name).shape == np.asarray(getattr(ref,
                                                              name)).shape
    assert _max_diff(out, ref, FLUXES) <= 1e-11
    assert _max_diff(out, ref, HEATING) <= 2e-9
    if icld:
        np.testing.assert_array_equal(out.cld_bounds_ok.numpy(),
                                      np.asarray(ref.cld_bounds_ok))
        # clouds change the all-sky fluxes, not the clear-sky ones
        assert not torch.allclose(out.uflx, out.uflxc)
    else:
        assert out.cld_bounds_ok is None


@pytest.mark.parametrize("icld", [0, 2])
def test_model_f32_within_reference_contract(icld):
    B, L = 8, 60
    _, ref = _jax(B, L, icld)
    out = make_model(LWConfig(icld=icld, imca=1, dtype="float32",
                              use_lut=False))(*_inputs(B, L, icld,
                                                       "float32"))
    assert out.uflx.dtype == torch.float32
    assert _max_diff(out, ref, ("uflx", "dflx")) < 5e-3
    assert _max_diff(out, ref, ("hr",)) < 0.05


def test_from_profile_is_the_call():
    B, L = 4, 12
    model = make_model(LWConfig(icld=2, use_lut=False))
    atm, clouds = _inputs(B, L, 2, "float64")
    a = model(atm, clouds)
    b = model.from_profile(inatm(atm), clouds)
    for name in FLUXES + HEATING:
        assert torch.equal(getattr(a, name), getattr(b, name))


def test_deep_profile_finite():
    """nlay=140 (the deep cell), McICA, float64 eager."""
    B, L = 2, 140
    out = make_model(LWConfig(icld=2, use_lut=False))(
        *_inputs(B, L, 2, "float64"))
    for name in FLUXES + HEATING:
        assert torch.isfinite(getattr(out, name)).all(), name
    assert out.uflx.shape == (B, L + 1) and out.hr.shape == (B, L)


def test_clouds_other_than_compact_raise():
    model = make_model(LWConfig(icld=2, use_lut=False))
    atm, _ = _inputs(2, 6, 0, "float64")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model(atm, (jnp.zeros(1),))
