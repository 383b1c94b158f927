"""The column mesh over ``torch.distributed``, and the batch's layout on it.

Port of ``rrtmg_lw_tpu.parallel.mesh`` (``:26-107``).  The physics is
independent per column, so the port parallelises over columns only: each
rank of the process group (NCCL on the card, gloo on the CPU) holds one
contiguous range of the columns on its own device and radiates it; the
only traffic between ranks is the metrics' reductions, the gradient
step's gather of the fluxes, and ``global_batch_from_host_shards``' check.

``Mesh.shape`` is {``COLUMNS``: world, ``SPEC``: 1}.  The JAX mesh's
spectral axis (``make_mesh(spec>1)``, a g-point split whose partial
fluxes are summed across ranks) is not ported: it raises
NotImplementedError (ROADMAP.md Queue 1, "the spectral partition").

``replicated`` and ``batch_sharding`` have no counterpart: a step's
outputs are this rank's shard, a plain tensor on its device, and what
JAX replicates (the wire format's reference profiles) every rank
receives whole.  ``shard_batch`` places a global host batch: it cuts
this rank's columns in each leaf's layout (``shardings_for``: batch-first
leaves on axis 0, the per-g (L, G, B) arrays of ``McicaCloudsBlocked``
and ``McicaCloudsCompact`` and a ``CompactCloudsWire``'s mask bits on
their last axis, a ``WireBatch``'s codes on axis 0 and its refs whole).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..types import McicaCloudsBlocked, McicaCloudsCompact

COLUMNS = "columns"
SPEC = "spec"


class Mesh(NamedTuple):
    """This rank's place on the column mesh: the process group (None for
    a one-rank mesh without ``torch.distributed``), its rank and size,
    and this rank's device."""
    group: Optional[object]
    rank: int
    world: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {COLUMNS: self.world, SPEC: 1}

    def rows(self, ncol: int) -> slice:
        """This rank's contiguous range of ``ncol`` columns."""
        return slice(self.rank * ncol // self.world,
                     (self.rank + 1) * ncol // self.world)


def make_mesh(spec: int = 1, device=None) -> Mesh:
    """The mesh of the initialized default process group, or a one-rank
    mesh where ``torch.distributed`` is not initialized.  ``device``:
    this rank's device, the CUDA device ``LOCAL_RANK`` (0 when unset)
    when None, which raises where there is no GPU; pass ``device="cpu"``
    for the CPU."""
    if spec != 1:
        raise NotImplementedError(
            f"make_mesh(spec={spec}): the spectral split of the g-points is "
            "not ported (ROADMAP.md Queue 1, the spectral partition); the "
            "mesh is over columns only")
    if dist.is_available() and dist.is_initialized():
        group, rank, world = (dist.group.WORLD, dist.get_rank(),
                              dist.get_world_size())
    else:
        group, rank, world = None, 0, 1
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "mesh on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return Mesh(group, rank, world, device)


def _leaf(x, mesh, axis, non_blocking=False):
    """This rank's columns of one leaf (cut on ``axis``), on its device."""
    from .wire import to_device
    if x is None:
        return None
    if axis is not None:
        n = np.shape(x)[axis]
        idx = [slice(None)] * np.ndim(x)
        idx[axis] = mesh.rows(n)
        x = x[tuple(idx)]
    return to_device(x, mesh.device, non_blocking)


def map_batch(tree, mesh, leaf=_leaf):
    """``tree`` with every leaf ``x`` replaced by ``leaf(x, mesh, axis)``,
    ``axis`` the leaf's column axis in its layout (None: replicated)."""
    from .wire import CompactCloudsWire, WireBatch

    def on(axis):
        return lambda x: leaf(x, mesh, axis)
    if isinstance(tree, McicaCloudsBlocked):
        return McicaCloudsBlocked(*map(on(-1), tree[:4]),
                                  *map(on(0), tree[4:]))
    if isinstance(tree, McicaCloudsCompact):
        return McicaCloudsCompact(on(-1)(tree.cldfmc),
                                  *map(on(0), tree[1:]))
    if isinstance(tree, WireBatch):
        return WireBatch({k: on(0)(v) for k, v in tree.cols.items()},
                         {k: _refs(r, on(None)) for k, r in tree.refs.items()})
    if isinstance(tree, CompactCloudsWire):
        return CompactCloudsWire(on(-1)(tree.mask_bits),
                                 map_batch(tree.fields, mesh, leaf))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*map(on(0), tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_batch(t, mesh, leaf) for t in tree)
    if isinstance(tree, dict):
        return {k: map_batch(t, mesh, leaf) for k, t in tree.items()}
    return on(0)(tree)


def _refs(r, fn):
    """A WireBatch refs entry with ``fn`` applied to its arrays."""
    if r is None:
        return None
    if isinstance(r, dict):
        return {k: fn(v) for k, v in r.items()}
    return tuple(fn(x) for x in r)


def shard_batch(tree, mesh: Mesh):
    """This rank's columns of the global host batch ``tree`` on its device
    (layout aware: see the module docstring)."""
    return map_batch(tree, mesh)


def _ncols(tree) -> set:
    """The column counts of ``tree``'s leaves, each in its layout."""
    seen = set()

    def leaf(x, mesh, axis):
        if x is not None and axis is not None:
            seen.add(int(np.shape(x)[axis]))
        return x
    map_batch(tree, Mesh(None, 0, 1, torch.device("cpu")), leaf)
    return seen


def global_batch_from_host_shards(mesh: Mesh, local):
    """The multi-host entry: each rank passes the column shard it loaded.
    Checks, with one all_gather, that every rank's shard holds one column
    count in all its leaves; -> (the shard on this rank's device, its
    global row range as a slice).  The ranks' shards stand in rank order
    along the columns, as ``host_local_array_to_global_array`` lays them
    (rrtmg_lw_tpu/parallel/mesh.py:89-107)."""
    seen = _ncols(local)
    n = seen.pop() if len(seen) == 1 else -1
    counts = [n]
    if mesh.group is not None:
        dev = mesh.device if dist.get_backend(mesh.group) == "nccl" \
            else torch.device("cpu")
        out = [torch.empty(1, dtype=torch.int64, device=dev)
               for _ in range(mesh.world)]
        dist.all_gather(out, torch.tensor([n], dtype=torch.int64,
                                          device=dev), group=mesh.group)
        counts = [int(t) for t in out]
    if min(counts) < 0:
        raise ValueError(f"host shards with mixed column counts (ranks' "
                         f"counts {counts}, -1: mixed)")
    lo = sum(counts[:mesh.rank])
    whole = map_batch(local, mesh, lambda x, m, axis: _leaf(x, m, None))
    return whole, slice(lo, lo + counts[mesh.rank])
