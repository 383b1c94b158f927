"""The port's sensitivities entry point (``rrtmg_lw_torch.examples.
sensitivities``) against the JAX package's (``examples/sensitivities.py``).

``sensitivities(model, atm)`` at 8 columns and 16 layers in float64, clear
sky at idrv=1, against ``jax.grad`` of the JAX example's ``mean_olr``
(``examples/sensitivities.py:57-63``), rebuilt here from
``rrtmg_lw_tpu.make_model`` on the same tables and the same seeded numpy
inputs: dOLR/dT, dOLR/dln q and dOLR/dTsfc within 1e-10 of their max
|value|, the idrv derivative at the top within 1e-10 (W/m2/K), and the
mean OLR within 1e-10 relative.  Then the module as a program on the CPU,
which prints the JAX example's four lines.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
from rrtmg_lw_tpu.utils import synthetic as jsyn

from rrtmg_lw_torch import Atmosphere, make_model
from rrtmg_lw_torch.data.ktables import tables_from_numpy
from rrtmg_lw_torch.examples import sensitivities as sens

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
B, L = 8, 16


def jax_sensitivities(jm, atm):
    """The JAX example's pass, as ``sens.sensitivities`` returns it."""
    def mean_olr(tlay, h2o, tsfc):
        fl = jm(atm._replace(tlay=tlay, h2ovmr=h2o, tsfc=tsfc))
        return fl.uflx[:, -1].mean(), fl

    (d_tlay, d_h2o, d_tsfc), fl = jax.jit(jax.grad(
        mean_olr, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(atm.tlay), jnp.asarray(atm.h2ovmr),
        jnp.asarray(atm.tsfc))
    n = atm.tlay.shape[0]
    return {"olr": float(fl.uflx[:, -1].mean()),
            "kernel_T": np.asarray(d_tlay) * n,
            "kernel_q": np.asarray(d_h2o) * atm.h2ovmr * n,
            "d_tsfc": np.asarray(d_tsfc) * n,
            "duflx_dt_toa": np.asarray(fl.duflx_dt)[:, -1]}


def test_sensitivities_match_jax_grad():
    jm = jmake_model(JConfig(icld=0, idrv=1, use_lut=False,
                             dtype="float64", taumol_impl="xla",
                             rt_impl="xla"))
    model = make_model(sens.CONFIG.replace(dtype="float64"), device="cpu",
                       tables=tables_from_numpy(jm.ktables, jm.static_np,
                                                device="cpu"))
    atm = jsyn.make_atmosphere(B, L)
    ref = jax_sensitivities(jm, atm)
    got = sens.sensitivities(model, Atmosphere.from_numpy(atm, "cpu"))
    assert set(got) == set(ref)
    assert abs(float(got["olr"]) / ref["olr"] - 1) <= 1e-10
    for name in ("kernel_T", "kernel_q", "d_tsfc"):
        g, r = got[name].numpy(), ref[name]
        assert g.shape == r.shape, name
        scale = np.abs(r).max()
        assert scale > 0, name
        assert np.abs(g - r).max() <= 1e-10 * scale, name
    d = got["duflx_dt_toa"].numpy()
    assert d.shape == (B,)
    assert np.abs(d - ref["duflx_dt_toa"]).max() <= 1e-10
    # the adjoint and the idrv derivative agree to the Planck table's
    # secant: close, not equal
    assert np.abs(got["d_tsfc"].numpy() - d).max() < 1e-2 * np.abs(d).max()


def test_sensitivities_program_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "rrtmg_lw_torch.examples.sensitivities",
         "--ncol", "16", "--nlay", "20", "--device", "cpu"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert len(lines) == 4, res.stdout
    assert lines[0].startswith("OLR mean: ") and "(16 columns, 20 layers)" \
        in lines[0]
    assert lines[1].startswith("dOLR/dT    peaks at layer ")
    assert lines[2].startswith("dOLR/dln q strongest at layer ")
    assert lines[3].startswith("dOLR/dTsfc: adjoint ") and "max |diff|" \
        in lines[3]
