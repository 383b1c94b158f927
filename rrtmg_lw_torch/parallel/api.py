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


def make_grad_step(model, loss_fn=None):
    """``step(atm, clouds=None) -> (loss, grads)``: the value of
    ``loss_fn(model(atm, clouds))`` and its gradient with respect to
    every field of ``atm``, as an ``Atmosphere`` of tensors shaped like
    the fields (zeros where the loss does not depend on a field).
    With ``impl="cuda"`` the backward runs the kernels' backward
    kernels; with ``impl="eager"`` plain autograd."""
    loss_fn = default_loss if loss_fn is None else loss_fn

    def step(atm: Atmosphere, clouds=None):
        leaves = {k: v.detach().requires_grad_()
                  for k, v in atm._asdict().items()}
        loss = loss_fn(model(Atmosphere(**leaves), clouds))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), Atmosphere(*(
            torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves.values(), grads)))

    return step
