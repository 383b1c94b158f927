"""Steps built around the model: the sharded forward step, the gradient
step and its sharded form.

Port of ``rrtmg_lw_tpu.parallel.api`` (``:31-99``), with the same default
loss.  ``make_grad_step`` is the one-device gradient step;
``make_sharded_step`` and ``make_sharded_grad_step`` run it on this
rank's column shard of a ``mesh.Mesh`` (``mesh.shard_batch`` places the
batch).  The JAX package bounded the memory of its XLA backward with a
column-chunked vjp (``ops/_vjp_chunk.py``); the port's backward kernels
keep their residuals at the size of taut/fracs, so it has no
counterpart.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..types import Atmosphere, Fluxes


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


def make_sharded_step(model, mesh):
    """``step(atm, clouds=None) -> Fluxes``: every rank runs ``model`` on
    its own column shard (the JAX step's ``shard_map`` mode,
    rrtmg_lw_tpu/parallel/api.py:53-66, the only one here: the physics is
    independent per column, and each rank launches its own kernels); the
    outputs are this rank's columns.  JAX's ``use_shard_map`` (GSPMD
    against ``shard_map``) and ``donate`` (XLA buffer donation) have no
    counterpart: there is no partitioner, and eager PyTorch frees an input
    when its last reference goes."""
    def step(atm, clouds=None):
        if atm.play.device != mesh.device:
            raise ValueError(f"batch on {atm.play.device}, this rank's "
                             f"device is {mesh.device}: place it with "
                             "shard_batch or prefetch")
        return model(atm, clouds)
    return step


class GatherColumns(torch.autograd.Function):
    """All-gather of a (b, ...) shard along the columns, in rank order,
    whose backward returns this rank's slice of the cotangent and nothing
    more.  Every rank computes the same global loss, so each holds the
    whole cotangent already; ``torch.distributed.nn``'s all_gather sums
    the ranks' cotangents in its backward, which would scale every
    gradient by the world size."""

    @staticmethod
    def forward(ctx, x, group, counts, rank):
        lo = sum(counts[:rank])
        ctx.rows = slice(lo, lo + counts[rank])
        top = max(counts)
        pad = x.new_zeros((top, *x.shape[1:]))
        pad[:x.shape[0]] = x
        parts = [torch.empty_like(pad) for _ in counts]
        dist.all_gather(parts, pad, group=group)
        return torch.cat([p[:n] for p, n in zip(parts, counts)])

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None, None, None


def gather_fluxes(fl: Fluxes, mesh) -> Fluxes:
    """The global ``Fluxes`` of every rank's shard ``fl``, in column
    order, on this rank's device; differentiable (``GatherColumns``).
    One-rank meshes without a process group return ``fl``."""
    if mesh.group is None:
        return fl
    dev = fl.uflx.device
    n = torch.tensor([fl.uflx.shape[0]], dtype=torch.int64, device=dev)
    parts = [torch.empty_like(n) for _ in range(mesh.world)]
    dist.all_gather(parts, n, group=mesh.group)
    counts = [int(p) for p in parts]

    def gather(x):
        if x is None:
            return None
        if x.dtype == torch.bool:
            return GatherColumns.apply(x.to(torch.uint8).contiguous(),
                                       mesh.group, counts, mesh.rank).bool()
        return GatherColumns.apply(x.contiguous(), mesh.group, counts,
                                   mesh.rank)
    return Fluxes(*map(gather, fl))


def make_sharded_grad_step(model, mesh, loss_fn=None):
    """``step(atm, clouds=None) -> (loss, grads)``: ``make_grad_step`` on
    this rank's shard (rrtmg_lw_tpu/parallel/api.py:77-99).  The loss is
    ``loss_fn`` (default ``default_loss``) of the GLOBAL Fluxes, gathered
    across the columns (``gather_fluxes``), so it is the same on every
    rank; the gradients are those of that loss with respect to this
    rank's shard of the Atmosphere."""
    loss_fn = default_loss if loss_fn is None else loss_fn
    return make_grad_step(model, lambda fl: loss_fn(gather_fluxes(fl, mesh)))
