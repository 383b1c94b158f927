"""The JAX package's production entry points (``examples/``), ported:
``gcm_step`` (the sharded GCM step over a prefetched stream) and
``wire_streaming`` (the compressed wire format decoded on the card).
Run as ``python -m rrtmg_lw_torch.examples.<name>``, or under
``torchrun --nproc_per_node=N -m rrtmg_lw_torch.examples.<name>``."""
