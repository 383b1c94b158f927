from .api import CLOUD_GRADS, MCICA_GRADS, RADII_GRADS, make_grad_step

__all__ = ["CLOUD_GRADS", "MCICA_GRADS", "RADII_GRADS", "make_grad_step"]
