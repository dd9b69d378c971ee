"""MojoFunction: dispatching base for training ops (forward and backward).

Counterpart of the JAX package's ``core/function.py:22``: a second
dispatch root beside ``MojoOperator``. Its tiers are ``nn.Module``s whose
``forward`` is differentiable: the golden tier through autograd of its
plain PyTorch math, a kernel tier through a ``torch.autograd.Function``
whose backward runs kernels too. Tier classes are named ``Ref<Name>`` and
``Cuda<Name>`` like the operators' (``MojoSWAFunction`` ->
``CudaSWAFunction``).
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator


class MojoFunction(MojoOperator, dispatch_root=True):
    def value_and_grad(self, *args, argnums=0, **kwargs):
        """The sum of every output, and its gradients with respect to the
        positional arguments ``argnums`` (an int or a tuple), as JAX's
        ``jax.value_and_grad`` of the summed outputs gives them (a None
        output, such as a final state not asked for, is no leaf there)."""
        nums = (argnums,) if isinstance(argnums, int) else tuple(argnums)
        args = [a.detach().requires_grad_(True) if i in nums else a for i, a in enumerate(args)]
        with torch.enable_grad():
            out = self(*args, **kwargs)
            leaves = out if isinstance(out, (tuple, list)) else (out,)
            total = sum(leaf.sum() for leaf in leaves if leaf is not None)  # None: an output not asked for
            grads = torch.autograd.grad(total, [args[i] for i in nums], allow_unused=True)
        return total.detach(), (grads[0] if isinstance(argnums, int) else tuple(grads))
