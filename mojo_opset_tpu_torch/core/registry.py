"""Per-op backend-tier registry.

Counterpart of the JAX package's ``core/registry.py``: name-prefix parsing
(``Ref<Name>``, ``Cuda<Name>``), priority sort, fallback to the
highest-priority registered tier, and the ``dispatch_default`` opt-out.
"""

from __future__ import annotations

from typing import Dict, Optional

from mojo_opset_tpu_torch.utils.logging import get_logger
from mojo_opset_tpu_torch.utils.platform import ALL_TIERS, BACKEND_PRIORITY

logger = get_logger(__name__)


class BackendNotAvailable(NotImplementedError):
    """Raised when a specific backend tier is requested but not registered."""


def _normalize_backend_name(backend_name: Optional[str]) -> Optional[str]:
    if backend_name is None:
        return None
    return backend_name.strip().lower()


def _priority_key(item) -> int:
    return BACKEND_PRIORITY.index(item[0])


class MojoBackendRegistry:
    def __init__(self, core_op_cls: type):
        if not core_op_cls.__name__.startswith("Mojo"):
            raise NameError(f"Core op {core_op_cls.__name__} must be named Mojo<OpName>.")
        self._core_op_cls = core_op_cls
        self._operator_name = core_op_cls.__name__[4:]
        self._registry: Dict[str, type] = {}

    @property
    def operator_name(self) -> str:
        return self._operator_name

    def register(self, cls: type) -> None:
        idx = cls.__name__.find(self._operator_name)
        if idx == -1:
            raise NameError(
                f"Implementation {cls.__name__} of {self._core_op_cls.__name__} must "
                f"contain {self._operator_name} in its class name."
            )
        tier = _normalize_backend_name(cls.__name__[:idx])
        if tier not in ALL_TIERS:
            raise NameError(
                f"Implementation {cls.__name__} tier [{tier}] is unknown; "
                f"expected one of {ALL_TIERS} as the class-name prefix."
            )

        if tier in self._registry:
            raise ValueError(
                f"{self._core_op_cls.__name__} tier [{tier}] has already been registered "
                f"({self._registry[tier].__name__})."
            )
        self._registry[tier] = cls
        cls._backend = tier
        self._registry = dict(sorted(self._registry.items(), key=_priority_key))

    def get(self, backend_name: Optional[str] = None, *, strict: bool = False) -> type:
        backend_name = _normalize_backend_name(backend_name)
        if backend_name is not None and backend_name in self._registry:
            return self._registry[backend_name]
        if strict and backend_name is not None:
            raise BackendNotAvailable(
                f"{self._operator_name} backend {backend_name!r} is not registered; "
                f"available: {list(self._registry)}"
            )
        if not self._registry:
            raise BackendNotAvailable(f"{self._operator_name} has no registered backend.")
        # an impl may opt out of default dispatch (dispatch_default = False)
        # while staying reachable by explicit tier name
        candidates = {
            t: c for t, c in self._registry.items() if getattr(c, "dispatch_default", True)
        } or self._registry
        fallback = min(candidates.items(), key=_priority_key)[1]
        if backend_name is not None:
            logger.debug(
                "Backend %r not registered for %s; falling back to %s.",
                backend_name,
                self._operator_name,
                fallback.__name__,
            )
        return fallback

    def registered_backends(self) -> tuple[str, ...]:
        return tuple(self._registry)
