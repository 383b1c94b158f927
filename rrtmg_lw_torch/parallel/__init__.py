from .api import CLOUD_GRADS, make_grad_step

__all__ = ["CLOUD_GRADS", "make_grad_step"]
