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

Training needs collectives that autograd sees (JAX's GSPMD places the
backward ones itself): ``sum_over_group`` (Megatron's *g*),
``copy_to_group`` (*f*), ``gather_from_group`` and ``mean_over_group`` (the
data-parallel mean, weighted by each rank's share) are
``torch.autograd.Function``s; the first three fall back to the in-place
calls where autograd is off, so serving and its CUDA graphs run what they ran.

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


# ---------------------------------------------------------------- autograd-aware forms
#
# A collective in place on a tensor that autograd tracks is the identity to
# the backward. The training path runs these instead: each a
# ``torch.autograd.Function`` whose backward is the collective the forward's
# transpose needs, in Megatron's terms (every rank of ``group`` computes the
# same loss, so a gradient that reaches a replicated tensor is replicated too).
# ``group=None`` is the identity, forward and backward.


class _SumOverGroup(torch.autograd.Function):
    """Megatron's *g*: the sum over the group forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's *f*: the identity forward, the sum over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    """``all_gather`` along ``dim`` forward; the backward keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather(x, group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        start = group_rank(ctx.group) * ctx.size
        return grad.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


class _MeanOverGroup(torch.autograd.Function):
    """The mean over the group weighted by each rank's ``weight`` (its share of
    the work, e.g. of the valid tokens): ``sum_r w_r x_r / sum_r w_r``. The
    backward gives each rank its share of the gradient, ``w_r / sum_r w_r``."""

    @staticmethod
    def forward(ctx, x, group, weight):
        w = torch.as_tensor(weight, dtype=torch.float32, device=x.device).reshape(())
        total = all_reduce(w.clone(), group)
        ctx.share = (w / total.clamp(min=1e-30)).to(x.dtype)  # no weight anywhere: 0
        return all_reduce((x * ctx.share).contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.share, None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``x`` (*g*: identity backward); the in-place ``all_reduce`` where autograd is off."""
    if group is None:
        return x
    return _SumOverGroup.apply(x, group) if _tracked(x) else all_reduce(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``group`` (*f*): the input of a column-parallel block."""
    if group is None or not _tracked(x):
        return x
    return _CopyToGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """``all_gather`` along ``dim``, whose backward keeps this rank's block; the plain gather where autograd is off."""
    if group is None:
        return x
    dim = dim % x.ndim
    return _GatherFromGroup.apply(x, group, dim) if _tracked(x) else all_gather(x, group, dim=dim)


def mean_over_group(x: torch.Tensor, group, weight=1.0) -> torch.Tensor:
    """The mean of ``x`` over ``group``, rank ``r`` weighted by its ``weight``
    (a number or a 0-d tensor): the data-parallel mean of a loss or of a
    gradient. Every rank's weights 1 give the plain mean; a group of one
    rank gives ``x`` bit for bit."""
    if group is None:
        return x
    return _MeanOverGroup.apply(x, group, weight)


def block_input(block: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the training forward of ``block`` reads it: through *f* (``copy_to_group``) where a parallel style
    marked the block's input as the replicated input of column-parallel projections (``mojo_input_group``)."""
    return copy_to_group(x, getattr(block, "mojo_input_group", None))


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
