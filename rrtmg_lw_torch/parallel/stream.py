"""Host->device input streaming with double buffering.

Port of ``rrtmg_lw_tpu.parallel.stream`` (``:29-80``).  ``prefetch``
keeps ``depth`` batches in flight ahead of the consumer: one worker
thread takes a host batch from the iterator (where a streaming caller
also generates or encodes it), cuts this rank's columns
(``mesh.map_batch``, the layout of ``shard_batch``), writes each leaf
into a pinned host buffer and starts its copy to the device with
``non_blocking`` on a dedicated copy stream, then records an event.  The
consumer makes the compute stream wait on that event before it yields,
and calls ``record_stream`` on every yielded tensor (they were allocated
on the copy stream: without it the caching allocator could hand their
memory to the copy of a later batch while the compute stream still reads
it).  A pinned buffer is refilled only after its last copy's event has
completed.  ``depth + 1`` sets of pinned buffers rotate.

With ``local=True`` the batches are this rank's own column shards (each
rank made its own, as ``global_batch_from_host_shards`` takes them) and
are placed whole.  On the CPU (the caller's ``device="cpu"`` mesh) the
worker only cuts and converts; there is no copy stream and no event.  ``depth=0`` streams
inline: each batch is placed by ``shard_batch`` on the consumer's thread,
its copy on the compute stream (the baseline the prefetch overlap is
measured against; the JAX ``prefetch`` yields nothing at depth 0).

The semantics the JAX package's tests pin hold: FIFO order, an exception
from the source surfaces at the consumer in order, breaking out of the
stream shuts the worker down (pending work cancelled, the running task
joined with a bound), and ``run_epoch`` does not splat NamedTuple
batches.
"""

from __future__ import annotations

import collections
import concurrent.futures
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from .mesh import _leaf, map_batch, shard_batch

_STOP = object()
JOIN_SECONDS = 60.0     # the bound on joining the worker's running task


class _Slot:
    """One batch's pinned host buffers and the event of their copies."""

    def __init__(self):
        self.buffers = []
        self.event = None

    def pinned(self, i, t):
        """Pinned buffer ``i``, refilled with the host tensor ``t``."""
        if i == len(self.buffers):
            self.buffers.append(None)
        buf = self.buffers[i]
        if buf is None or buf.dtype != t.dtype or buf.shape != t.shape:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.buffers[i] = buf
        buf.copy_(t)
        return buf


def _host(x):
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    # uint16 codes cross as int16 (the copy moves bytes only)
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _put_cuda(tree, mesh, slot, copy_stream):
    """``tree``'s leaves for this rank, copied through ``slot``'s pinned
    buffers on ``copy_stream`` -> (device tree, the copies' event)."""
    if slot.event is not None:
        slot.event.synchronize()        # the buffers' last copies are done
    n = [0]

    def leaf(x, mesh, axis):
        if x is None:
            return None
        h = _leaf(x, mesh._replace(device=torch.device("cpu")), axis)
        uint16 = h.dtype == torch.uint16
        buf = slot.pinned(n[0], _host(h))
        n[0] += 1
        dev = torch.empty(buf.shape, dtype=buf.dtype, device=mesh.device)
        dev.copy_(buf, non_blocking=True)
        return dev.view(torch.uint16) if uint16 else dev

    with torch.cuda.device(mesh.device), torch.cuda.stream(copy_stream):
        out = map_batch(tree, mesh, leaf)
        slot.event = torch.cuda.Event()
        slot.event.record(copy_stream)
    return out, slot.event


def _tensors(tree):
    """Every tensor of a placed batch."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def prefetch(batches: Iterable, mesh, depth: int = 2,
             local: bool = False) -> Iterator:
    """Yield this rank's device-resident batches of the host ``batches``
    (global batches, or with ``local`` this rank's own shards), keeping
    ``depth`` transfers in flight on a background thread (see the module
    docstring)."""
    if local:
        mesh = mesh._replace(rank=0, world=1)       # nothing to cut
    if depth == 0:
        for b in batches:
            yield shard_batch(b, mesh)
        return
    it = iter(batches)
    cuda = mesh.device.type == "cuda"
    if cuda:
        copy_stream = torch.cuda.Stream(device=mesh.device)
        slots = collections.deque(_Slot() for _ in range(depth + 1))

    def feed():
        # only the worker thread touches the iterator
        try:
            nxt = next(it)
        except StopIteration:
            return _STOP
        if not cuda:
            return shard_batch(nxt, mesh), None
        slots.rotate(-1)
        return _put_cuda(nxt, mesh, slots[0], copy_stream)

    ex = ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="rrtmg-prefetch")
    queue = collections.deque()
    try:
        queue.extend(ex.submit(feed) for _ in range(depth))
        while queue:
            ready = queue.popleft().result()
            if ready is _STOP:
                break            # FIFO: everything behind is _STOP too
            queue.append(ex.submit(feed))
            batch, event = ready
            if cuda:
                compute = torch.cuda.current_stream(mesh.device)
                compute.wait_event(event)
                for t in _tensors(batch):
                    t.record_stream(compute)
            yield batch
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
        concurrent.futures.wait([f for f in queue if not f.cancelled()],
                                timeout=JOIN_SECONDS)


def run_epoch(step_fn: Callable, batches: Iterable, mesh,
              depth: int = 2, callback: Optional[Callable] = None,
              local: bool = False):
    """Drive ``step_fn`` over a stream of host batches with prefetch."""
    out = None
    for dev_batch in prefetch(batches, mesh, depth=depth, local=local):
        # splat only plain tuples: NamedTuple batches (Atmosphere, cloud
        # tuples) are single arguments
        splat = (isinstance(dev_batch, tuple)
                 and not hasattr(dev_batch, "_fields"))
        out = step_fn(*dev_batch) if splat else step_fn(dev_batch)
        if callback is not None:
            callback(out)
    return out
