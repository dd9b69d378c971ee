"""The comm layer: the collectives that a sharded model runs, and the
communication context of the compute+comm ops.

Counterpart of the JAX package's ``runtime/comm_context.py``
(``MojoSymmetricMemoryManager`` :26, ``MojoComputeCommContext`` :62). The
JAX package names a mesh axis and lets ``shard_map`` / GSPMD place the
collectives; the port holds explicit ``torch.distributed`` process groups
(``parallel.mesh``) and calls the collectives itself, on plain local
tensors: NCCL on the card, gloo on the CPU. Every collective takes
``group=None`` as the single-rank identity (JAX's ``axis_name=None``), and
JAX's tiled semantics: ``all_gather`` concatenates the ranks' blocks along
``dim`` in rank order, ``reduce_scatter`` sums and leaves rank ``r`` the
``r``-th block, ``all_to_all`` sends block ``i`` of ``split_dim`` to rank
``i`` and concatenates what it receives along ``concat_dim``.

A module that runs a collective keeps its group in an attribute, so
``model_groups`` finds every group a model communicates over: the CUDA-graph
pool asks it whether the model's collectives can be captured (NCCL's can,
gloo's cannot).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from mojo_opset_tpu_torch.utils.platform import resolve_device

_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` (sum, max or min); in place when ``x`` is contiguous."""
    if group is None:
        return x
    if not x.is_contiguous():
        x = x.contiguous()
    dist.all_reduce(x, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]), group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    front = x.movedim(dim, 0).contiguous()
    if dist.get_backend(group) == "gloo":  # gloo gathers into a list, on the CPU and on the card alike
        parts = [torch.empty_like(front) for _ in range(n)]
        dist.all_gather(parts, front, group=group)
        out = torch.cat(parts)
    else:
        out = front.new_empty((n * front.shape[0],) + tuple(front.shape[1:]))
        dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over ``group`` of ``x``, of which rank ``r`` keeps the ``r``-th block along ``dim``."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    front = x.movedim(dim, 0).contiguous()
    if front.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size {front.shape[0]} does not split over {n} ranks")
    out = front.new_empty((front.shape[0] // n,) + tuple(front.shape[1:]))
    dist.reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, dim).contiguous()


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Block ``i`` of ``x`` along ``split_dim`` goes to rank ``i``; the blocks received are concatenated along
    ``concat_dim`` in rank order."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    front = x.movedim(split_dim, 0)
    if front.shape[0] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size {front.shape[0]} does not split over {n} ranks")
    send = front.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    blocks = recv.reshape((n, front.shape[0] // n) + tuple(front.shape[1:]))
    return torch.cat([b.movedim(0, split_dim) for b in blocks.unbind(0)], dim=concat_dim)


def model_groups(model: torch.nn.Module) -> list:
    """Every process group that a module of ``model`` communicates over (the groups its modules hold)."""
    seen: Dict[int, object] = {}
    for module in model.modules():
        for value in vars(module).values():
            if isinstance(value, dist.ProcessGroup):
                seen.setdefault(id(value), value)
    return list(seen.values())


class MojoSymmetricMemoryManager:
    """One manager a process group (JAX keys them by mesh axis): the buffers
    that comm-fused kernels would share between ranks. The port's collectives
    run through NCCL, which owns its transport buffers, so ``create_tensor``
    gives a plain device buffer and ``team_split_strided`` the group itself
    (sub-teams come from ``parallel.mesh``), keeping the reference's API."""

    _instances: Dict[object, "MojoSymmetricMemoryManager"] = {}

    def __init__(self, group=None, size_mb: int = 20, device=None):
        self.group = group
        self.size_mb = size_mb
        self.device = resolve_device(device)

    @classmethod
    def get(cls, group=None, size_mb: int = 20, device=None) -> "MojoSymmetricMemoryManager":
        key = "<world>" if group is None else group
        if key not in cls._instances:
            cls._instances[key] = cls(group, size_mb, device)
        return cls._instances[key]

    def create_tensor(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def team_split_strided(self, stride: int):
        return self.group


class MojoComputeCommContext:
    """Cache of compute+comm op instances and workspaces for one group,
    keyed as the JAX package keys them: (op class, weight identity, the
    keyword arguments, tensors by identity)."""

    def __init__(self, group=None, device=None):
        self.group = group
        self._ops: Dict[Tuple, object] = {}
        self._workspaces: Dict[Tuple, torch.Tensor] = {}
        self.shmem = MojoSymmetricMemoryManager.get(group, device=device)

    def get_op(self, op_cls, weight, **kwargs):
        def key_of(v):
            return ("id", id(v)) if isinstance(v, torch.Tensor) else v

        key = (op_cls.__name__, id(weight), tuple(sorted((name, key_of(v)) for name, v in kwargs.items())))
        if key not in self._ops:
            self._ops[key] = op_cls(weight, group=self.group, **kwargs)
        return self._ops[key]

    def get_workspace(self, name: str, shape, dtype) -> torch.Tensor:
        key = (name, tuple(shape), dtype)
        if key not in self._workspaces:
            self._workspaces[key] = self.shmem.create_tensor(shape, dtype)
        return self._workspaces[key]


def capturable(group) -> Optional[str]:
    """None when a CUDA graph can capture ``group``'s collectives (NCCL), else its backend's name."""
    backend = dist.get_backend(group)
    return None if backend == "nccl" else backend
