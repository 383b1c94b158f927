from .mesh import (COLUMNS, SPEC, Mesh, global_batch_from_host_shards,
                   make_mesh, shard_batch)
from .api import (CLOUD_GRADS, MCICA_GRADS, RADII_GRADS, make_grad_step,
                  make_sharded_grad_step, make_sharded_step)
from .metrics import flux_error_norms, flux_stats, make_metrics_fn
from .stream import prefetch, run_epoch
from . import wire

__all__ = [
    "COLUMNS", "SPEC", "Mesh", "make_mesh", "shard_batch",
    "global_batch_from_host_shards", "CLOUD_GRADS", "MCICA_GRADS",
    "RADII_GRADS", "make_grad_step", "make_sharded_step",
    "make_sharded_grad_step", "prefetch", "run_epoch", "flux_stats",
    "flux_error_norms", "make_metrics_fn", "wire",
]
