"""Steps built around the model: the gradient step.

One-device counterpart of ``rrtmg_lw_tpu.parallel.api.
make_sharded_grad_step`` (rrtmg_lw_tpu/parallel/api.py:77-99), with the
same default loss.  The mesh, the column sharding and
``make_sharded_step`` are not ported yet (ROADMAP.md Queue 1, the
parallel layer).
The JAX package bounded the memory of its XLA backward with a
column-chunked vjp (``ops/_vjp_chunk.py``); the port's backward kernels
keep their residuals at the size of taut/fracs, so it has no
counterpart.
"""

from __future__ import annotations

import torch

from ..types import Atmosphere


def default_loss(fl):
    """Mean squared total-sky heating rate plus mean squared outgoing
    longwave flux (rrtmg_lw_tpu/parallel/api.py:86-87)."""
    return (fl.hr ** 2).mean() + (fl.uflx[:, -1] ** 2).mean()


# BandClouds fields a gradient step differentiates besides the Atmosphere:
# the cloud fraction and water paths, and the effective radii (through
# K4's backward, K4b; with inflag=2)
CLOUD_GRADS = ("cldfrac", "ciwp", "clwp")
RADII_GRADS = ("reic", "relq")
# the fields of McicaCloudsBlocked / McicaClouds (inflag=2 reads them all,
# inflag=0 cldfmc and taucmc)
MCICA_GRADS = ("cldfmc", "ciwpmc", "clwpmc", "taucmc", "reicmc", "relqmc")


def make_grad_step(model, loss_fn=None, cloud_fields=()):
    """``step(atm, clouds=None) -> (loss, grads)``: the value of
    ``loss_fn(model(atm, clouds))`` and its gradient with respect to
    every field of ``atm``, as an ``Atmosphere`` of tensors shaped like
    the fields (zeros where the loss does not depend on a field).
    ``cloud_fields`` (names of ``clouds`` fields, e.g. ``CLOUD_GRADS`` +
    ``RADII_GRADS`` of BandClouds, ``MCICA_GRADS`` of McicaCloudsBlocked):
    the step returns ``(loss, grads, cloud_grads)``, the gradients with
    respect to those fields in their order as well (zeros where the loss
    does not depend on one).
    With ``impl="cuda"`` the backward runs the kernels' backward
    kernels; with ``impl="eager"`` plain autograd."""
    loss_fn = default_loss if loss_fn is None else loss_fn
    cloud_fields = tuple(cloud_fields)

    def step(atm: Atmosphere, clouds=None):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in atm._asdict().items()}
        cl = {k: getattr(clouds, k).detach().requires_grad_()
              for k in cloud_fields}
        if cl:
            clouds = clouds._replace(**cl)
        xs = [*leaves.values(), *cl.values()]
        loss = loss_fn(model(Atmosphere(**leaves), clouds))
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
            xs, torch.autograd.grad(loss, xs, allow_unused=True))]
        atm_grads = Atmosphere(*grads[:len(leaves)])
        if not cloud_fields:
            return loss.detach(), atm_grads
        return loss.detach(), atm_grads, tuple(grads[len(leaves):])

    return step
