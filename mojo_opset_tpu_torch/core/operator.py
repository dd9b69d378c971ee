"""MojoOperator: dispatching ``nn.Module`` op base.

Counterpart of the JAX package's ``core/operator.py``:
  * ``__init_subclass__`` attaches a per-core-op registry and auto-creates
    the golden tier ``Ref<Name>`` from the core class's own ``forward``;
  * ``__new__`` dispatches construction of the core class to the tier
    selected by ``MOJO_BACKEND`` (default: the platform priority, ``cuda``
    first);
  * ``forward_diff_with`` runs two tiers on the same inputs and compares.

The JAX package's pytree ``Module`` becomes ``torch.nn.Module``: weights
are ``nn.Parameter``s, built with ``requires_grad=False`` (serving is the
default; a trainer turns gradients on with ``requires_grad_(True)`` and
trains through the golden ops and the ``MojoFunction`` tiers: the
forward-only kernel wrappers of the ``cuda`` tier raise on an input that
needs a gradient in grad mode), and ops that JAX returns functionally
(the KV store) update their inputs in place.

``dispatch_root=True`` marks an abstract root (``MojoOperator`` itself):
direct subclasses of a root are *core ops* that get a registry; deeper
subclasses are tier implementations that auto-register.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.registry import MojoBackendRegistry
from mojo_opset_tpu_torch.utils.acc import check_tol_diff


class MojoOperator(nn.Module):
    _backend: Optional[str] = None
    _registry: Optional[MojoBackendRegistry] = None
    _dispatch_root: type = None  # set below, after class creation

    def __init_subclass__(cls, dispatch_root: bool = False, **kwargs):
        super().__init_subclass__(**kwargs)

        if dispatch_root:
            cls._dispatch_root = cls
            return

        if cls._dispatch_root in cls.__bases__:
            cls._registry = MojoBackendRegistry(cls)
            # the golden 'ref' tier is the core class's own forward
            type("Ref" + cls._registry.operator_name, (cls,), {"__module__": cls.__module__})
        else:
            if cls._registry is None:
                raise TypeError(
                    f"{cls.__name__} subclasses a non-core op; implementation tiers must "
                    f"directly subclass the Mojo core op class."
                )
            cls._registry.register(cls)

    def __new__(cls, *args, **kwargs):
        if cls._dispatch_root in cls.__bases__:
            target_class = cls.get_registry().get(os.environ.get("MOJO_BACKEND"))
            return target_class.__new__(target_class, *args, **kwargs)
        return super().__new__(cls)

    @classmethod
    def get_registry(cls) -> MojoBackendRegistry:
        if cls._registry is None:
            raise NotImplementedError(f"No {cls.__name__} implementation found.")
        return cls._registry

    @classmethod
    def get_backend_impl(cls, backend_name: Optional[str] = None, *, strict: bool = False):
        return cls.get_registry().get(backend_name, strict=strict)

    @classmethod
    def get_registered_backends(cls) -> tuple[str, ...]:
        return cls.get_registry().registered_backends()

    def forward_diff_with(
        self,
        other_op: "MojoOperator",
        *args,
        atol: float = 1e-2,
        rtol: float = 1e-2,
        ptol: float = 1.0,
        mixed_tol: bool = False,
        **kwargs,
    ):
        """Run this op and ``other_op`` on the same inputs and compare.

        Tensor arguments are cloned for each side, since some ops (the KV
        store) write into their inputs.
        """
        if type(self) is type(other_op):
            raise NotImplementedError(
                f"No dedicated backend for {type(self).__name__}; both operands resolve "
                f"to the same implementation, skipping comparison."
            )

        def cloned(values):
            return [v.clone() if isinstance(v, torch.Tensor) else v for v in values]

        norm_result = self(*cloned(args), **dict(zip(kwargs, cloned(kwargs.values()))))
        refs_result = other_op(*cloned(args), **dict(zip(kwargs, cloned(kwargs.values()))))
        if norm_result is None or refs_result is None:
            raise AssertionError("forward should return a non-None value.")
        check_tol_diff(norm_result, refs_result, atol, rtol, ptol, mixed_tol)
        return norm_result


MojoOperator._dispatch_root = MojoOperator
