"""Tools of the port: ``gpu_verify``, the one-shot on-card verification
(the counterpart of the JAX package's ``tools/tpu_verify.py``).  Run as
``python -m rrtmg_lw_torch.tools.<name>``."""
