"""Per-op benchmark spec API.

Counterpart of the JAX package's ``benchmark/api.py`` (:28-176):
``perf_case`` (smoke/full tags), ``@mojo_perf(name, target, cases,
providers, profiling)``, ``PerfWorkload`` (input tensors, op kwargs, state
bound onto the op, args, kwargs, flops and bytes, threaded outputs),
``perf_provider`` with a ``supports`` predicate, ``profile`` kernel
selection and ``discover_perf_specs``. Providers are the port's tiers,
``ref`` and ``cuda``.

Inputs are made from their index in the workload: int32 and int8 inputs
from ``np.random.default_rng(index)`` exactly as the JAX package draws them
(so token ids and slots agree between the two packages), float inputs
from a ``torch.Generator`` seeded with ``index`` on the target device.
"""

from __future__ import annotations

import importlib
import pkgutil
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class PerfCase:
    id: str
    params: Mapping[str, Any]
    tags: Tuple[str, ...] = ()


def perf_case(case_id: str, *, tags: Sequence[str] = (), **params: Any) -> PerfCase:
    return PerfCase(id=case_id, params=dict(params), tags=tuple(tags))


@dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    creator: Optional[Callable] = None

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        if any(d < 0 for d in self.shape):
            raise ValueError(f"tensor shape must be non-negative, got {self.shape}")

    def build(self, index: int, device="cpu") -> torch.Tensor:
        """The input at position ``index`` of its workload, on ``device``."""
        device = torch.device(device)
        if self.creator is not None:
            return torch.as_tensor(self.creator(self)).to(device)
        if self.dtype in (torch.int32, torch.int8):
            rng = np.random.default_rng(index)
            hi = 127 if self.dtype == torch.int8 else 1000
            return torch.from_numpy(rng.integers(0, hi, self.shape)).to(device=device, dtype=self.dtype)
        gen = torch.Generator(device=device).manual_seed(index)
        return torch.randn(self.shape, generator=gen, device=device).to(self.dtype)


def tensor(shape: Sequence[int], dtype: torch.dtype, *, creator: Optional[Callable] = None) -> TensorSpec:
    return TensorSpec(shape=tuple(shape), dtype=dtype, creator=creator)


@dataclass(frozen=True)
class LiteralArg:
    value: Any


def literal(value: Any) -> LiteralArg:
    return LiteralArg(value)


@dataclass(frozen=True)
class PerfWorkload:
    """Provider-independent op construction and call.

    String values in ``args`` / ``kwargs`` name input tensors; ``state``
    binds input tensors onto the op's parameters or buffers (``{attribute:
    input name}``); ``flops`` and the bytes feed the throughput columns;
    ``run(op, *args, **kwargs)`` replaces the plain call; ``thread``
    (``{arg name: output position}``) feeds outputs back as arguments
    across a timing chain, so an op that writes its state in place (a KV
    cache store) never copies it a call.
    """

    inputs: Mapping[str, TensorSpec]
    outputs: Mapping[str, TensorSpec] = field(default_factory=dict)
    op_kwargs: Mapping[str, Any] = field(default_factory=dict)
    state: Mapping[str, str] = field(default_factory=dict)
    forward_args: Optional[Tuple[Any, ...]] = None
    args: Optional[Tuple[Any, ...]] = None
    kwargs: Mapping[str, Any] = field(default_factory=dict)
    flops: int = 0
    read_bytes: Optional[float] = None
    write_bytes: Optional[float] = None
    run: Optional[Callable] = None
    thread: Mapping[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if self.args is None:
            omitted = set(self.state.values()) | {v for v in self.kwargs.values() if isinstance(v, str)}
            object.__setattr__(self, "args", tuple(n for n in self.inputs if n not in omitted))
        refs = {v for v in (*self.args, *self.kwargs.values()) if isinstance(v, str)}
        refs |= set(self.state.values())
        missing = refs - set(self.inputs)
        if missing:
            raise ValueError(f"workload references undefined input tensors: {sorted(missing)}")


@dataclass(frozen=True)
class ProfileSpec:
    timing: str = "device"
    kernels: Optional[Tuple[str, ...]] = None
    match: str = "any"
    reduction: str = "span"


def profile(timing: str = "device", kernels=None, match="any", reduction="span") -> ProfileSpec:
    return ProfileSpec(timing, tuple(kernels) if kernels else None, match, reduction)


@dataclass(frozen=True)
class PerfProvider:
    name: str
    supports: Optional[Callable[[PerfCase], bool]] = None


def perf_provider(name: str, supports: Optional[Callable] = None) -> PerfProvider:
    return PerfProvider(name, supports)


@dataclass
class PerfSpec:
    name: str
    target: Any  # the Mojo core op class
    cases: Tuple[PerfCase, ...]
    providers: Tuple[PerfProvider, ...]
    workload_fn: Callable[[PerfCase], PerfWorkload]
    profiling: ProfileSpec = field(default_factory=ProfileSpec)


PERF_REGISTRY: Dict[str, PerfSpec] = {}

DEFAULT_PROVIDERS = (perf_provider("ref"), perf_provider("cuda"))

DESCRIPTORS = "mojo_opset_tpu_torch.benchmark.specs"


def mojo_perf(
    name: str,
    target,
    cases: Sequence[PerfCase],
    providers: Sequence[PerfProvider] = DEFAULT_PROVIDERS,
    profiling: ProfileSpec = ProfileSpec(),
):
    """Register a perf spec; the decorated function maps a case to a ``PerfWorkload``."""

    def deco(fn):
        PERF_REGISTRY[name] = PerfSpec(
            name=name, target=target, cases=tuple(cases),
            providers=tuple(providers), workload_fn=fn, profiling=profiling,
        )
        return fn

    return deco


def discover_perf_specs(package: str = DESCRIPTORS) -> Dict[str, PerfSpec]:
    """Import every module under the descriptor package, so that their
    ``@mojo_perf`` registrations run."""
    pkg = importlib.import_module(package)
    for mod in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + "."):
        importlib.import_module(mod.name)
    return PERF_REGISTRY
