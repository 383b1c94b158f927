"""The gradient step (``make_grad_step``) on the configurations the port
took last: the default config (float64, use_lut=True, clear sky) and a
running-ncbands config (per-band clouds, icld=1, iceflag=1, the default
use_lut=True), against ``jax.value_and_grad`` of the JAX model (XLA
engines) in float64, through the plain versions (``impl="eager"``) and
through the kernel wrappers' Functions (``impl="cuda"`` on the CPU: their
plain vjps, and the LUT sweep's plain autograd).  The LUT factors are
piecewise constant in the optical depth on both sides: where a cloud od
reaches the fluxes only through them (maximum-random overlap) its
water-path gradient is zero, so the ncbands case takes random overlap,
whose cloudy transmittance 1 - exp(-od) carries one.

Then, without JAX, the ncbands gradient step at use_lut=False through K1's
banded / maxrand Functions against plain autograd (1e-12 relative).

Tolerances (tests/test_torch_grad.py's): 1e-12 relative on the loss,
1e-10 of max |JAX| per Atmosphere field and per cloud field.
"""

import pytest
import torch

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig as JConfig, make_model as jmake_model
from rrtmg_lw_tpu.types import BandClouds as JBandClouds

from rrtmg_lw_torch import Atmosphere, BandClouds, LWConfig, make_model
from rrtmg_lw_torch.data.ktables import tables_from_numpy
from rrtmg_lw_torch.parallel import CLOUD_GRADS, make_grad_step
from rrtmg_lw_torch.utils import synthetic as tsyn
from test_torch_grad import noisy_atmosphere, rel_err

torch.set_num_threads(1)


def _models(kw, jm):
    """The port's model of ``kw`` on the JAX model's tables, impl "eager"
    and "cuda" (the Functions, on the CPU)."""
    tables = tables_from_numpy(jm.ktables, jm.static_np, device="cpu")
    for impl in ("eager", "cuda"):
        model = make_model(LWConfig(**kw), device="cpu", tables=tables)
        model.impl = impl
        yield impl, model


def test_default_grad_step_matches_jax_value_and_grad():
    B, L = 4, 12
    jm = jmake_model(JConfig(taumol_impl="xla", rt_impl="xla"))
    natm = noisy_atmosphere(B, L)

    def jloss(a):
        fl = jm(a, None)
        return (fl.hr ** 2).mean() + (fl.uflx[:, -1] ** 2).mean()

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, natm))
    for impl, model in _models({}, jm):
        assert model.luts is not None and not model.rt_kernels
        loss, g = make_grad_step(model)(Atmosphere.from_numpy(natm, "cpu"))
        assert abs(float(loss) - float(jl)) <= 1e-12 * abs(float(jl)), impl
        for name in Atmosphere._fields:
            assert rel_err(getattr(g, name), getattr(jg, name)) <= 1e-10, \
                (impl, name)
        assert float(g.tlay.abs().max()) > 0


def test_ncbands_grad_step_matches_jax_value_and_grad():
    B, L = 8, 12
    kw = dict(icld=1, imca=0, iceflag=1, liqflag=1)
    jm = jmake_model(JConfig(taumol_impl="xla", rt_impl="xla", **kw))
    natm, nbc = noisy_atmosphere(B, L), tsyn.make_ncbands_clouds(B, L)

    def jloss(a, cw):
        fl = jm(a, JBandClouds(*nbc)._replace(**cw))
        return (fl.hr ** 2).mean() + (fl.uflx[:, -1] ** 2).mean()

    cw = {k: jnp.asarray(getattr(nbc, k)) for k in CLOUD_GRADS}
    jl, (ja, jc) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, natm), cw)
    for impl, model in _models(kw, jm):
        loss, g, gc = make_grad_step(model, cloud_fields=CLOUD_GRADS)(
            Atmosphere.from_numpy(natm, "cpu"),
            BandClouds.from_numpy(nbc, "cpu"))
        assert abs(float(loss) - float(jl)) <= 1e-12 * abs(float(jl)), impl
        for name in Atmosphere._fields:
            assert rel_err(getattr(g, name), getattr(ja, name)) <= 1e-10, \
                (impl, name)
        for name, got in zip(CLOUD_GRADS, gc):
            assert bool((got != 0).any()), (impl, name)
            assert rel_err(got, jc[name]) <= 1e-10, (impl, name)


@pytest.mark.parametrize("icld", [1, 2])
def test_ncbands_kernel_route_grad_on_cpu(icld):
    """use_lut=False: the ncbands od goes to K1 banded / maxrand as the
    ratio prefold; on the CPU their Functions run the plain forward and
    vjp, so the gradient step (Atmosphere and CLOUD_GRADS) equals plain
    autograd's."""
    B, L = 4, 12
    cfg = LWConfig(icld=icld, imca=0, iceflag=1, liqflag=1, use_lut=False)
    atm = Atmosphere.from_numpy(tsyn.make_atmosphere(B, L), "cpu")
    bc = BandClouds.from_numpy(tsyn.make_ncbands_clouds(B, L), "cpu")
    eager = make_model(cfg, device="cpu")
    kernels = make_model(cfg, device="cpu")
    kernels.impl = "cuda"
    assert kernels.rt_kernels and not eager.rt_kernels
    le, ge, ce = make_grad_step(eager, cloud_fields=CLOUD_GRADS)(atm, bc)
    lk, gk, ck = make_grad_step(kernels, cloud_fields=CLOUD_GRADS)(atm, bc)
    assert torch.equal(le, lk)
    for name, a, b in zip((*Atmosphere._fields, *CLOUD_GRADS), (*gk, *ck),
                          (*ge, *ce)):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * max(scale, 1e-300), name
    assert all(bool((c != 0).any()) for c in ck)
