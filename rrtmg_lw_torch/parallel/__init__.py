from .api import make_grad_step

__all__ = ["make_grad_step"]
