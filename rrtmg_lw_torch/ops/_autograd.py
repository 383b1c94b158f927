"""The plain vjp behind every kernel's ``torch.autograd.Function``.

A Function's CPU backward (and the reference its backward kernel is
held against on the card) is the vjp of the kernel's plain PyTorch
version: the plain forward recomputed under ``torch.enable_grad()`` and
differentiated by ``torch.autograd.grad``.
"""

from __future__ import annotations

import torch


def plain_vjp(fn, inputs, needs, cts):
    """Cotangents of ``fn(*inputs)``'s inputs: a tensor for each input
    flagged in ``needs`` (zeros where the output does not depend on it),
    None for the others.  ``cts``: one cotangent per output of ``fn``."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() if need else x
              for x, need in zip(inputs, needs)]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [x for x, need in zip(xs, needs) if need]
        got = torch.autograd.grad(outs, wrt, cts, allow_unused=True)
    got = iter(torch.zeros_like(x) if g is None else g
               for x, g in zip(wrt, got))
    return tuple(next(got) if need else None for need in needs)
