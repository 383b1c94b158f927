"""The process group of an entry point launched by ``torchrun``."""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist


@contextlib.contextmanager
def process_group(device):
    """Initialize the default process group (NCCL on the card, gloo on
    the CPU) where ``torchrun`` set ``WORLD_SIZE``, destroy it after; a
    plain ``python -m`` run has no group (a one-rank mesh)."""
    if "WORLD_SIZE" not in os.environ:
        yield
        return
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if cpu else "nccl")
    try:
        yield
    finally:
        dist.destroy_process_group()


def all_finite(x, mesh) -> bool:
    """True where every element of every rank's ``x`` is finite."""
    bad = (~torch.isfinite(x)).sum().to(torch.int64).reshape(1)
    if mesh.group is not None:
        dist.all_reduce(bad, group=mesh.group)
    return int(bad) == 0
