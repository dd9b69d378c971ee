"""Parallel styles: tensor, expert and data parallelism of a module, with
explicit collectives.

Counterpart of the JAX package's ``parallel/styles.py`` (``MojoParallelStyle``
:44, ``MojoColwiseParallel`` :67, ``MojoRowwiseParallel`` :78,
``MojoQKVColwiseParallel`` :87, ``MojoSwiGLUParallel`` :116,
``MojoTensorParallel`` :137, ``MojoDataParallel`` :156,
``MojoExpertParallel`` :166, ``MojoRegisterableParallelStyle`` :183,
``MojoDistributedModule`` :262, ``mojo_parallelize_module`` :293).

JAX gives each array a ``NamedSharding`` and lets GSPMD insert the
collectives. Here a style changes the module in place: each weight it
shards becomes the rank's slice, a plain ``nn.Parameter``, and the
collective that the module's output needs runs through the comm layer
(``runtime.comm_context``), as a forward hook on the module. Kernels, the
CUDA-graph pool and NCCL (whose collectives a graph can capture) all see
plain tensors. The result is the unsharded model's function:

  * column-parallel (``MojoColwiseParallel``): the rank's output channels;
    with ``gather_output`` (the vocab-parallel LM head) the output is
    all-gathered along its last dim;
  * row-parallel (``MojoRowwiseParallel``): the rank's input channels, the
    output summed over the group (a bias is kept on rank 0 only, so it is
    added once);
  * attention (``MojoQKVColwiseParallel``): whole heads. Each rank keeps its
    query heads and the kv heads those attend, under the AABB layout (query
    head h reads kv head h // group) or ABAB (h % num_kv_heads); past
    ``tp = num_kv_heads`` a kv head is kept by every rank whose query heads
    read it (JAX replicates all of them; a slice of a head would pair the
    wrong heads). The attention's head counts become the rank's, and
    ``o_proj`` is row-parallel over the same heads (JAX leaves it whole and
    lets GSPMD gather);
  * a dynamic int8 quant whose input is the rank's slice of each row (before
    a row-parallel projection) takes its amax over the group
    (``MojoDynamicQuant.amax_group``), so it quantizes as the whole row;
  * the fused SwiGLU ``fc1`` shards its gate and up halves each on its own
    (a plain split of the fused rows would pair gate with up of other
    channels, the corruption JAX's note at :116-131 describes);
  * experts (``MojoExpertParallel``): the MoE keeps the rank's experts and
    sums the ranks' outputs (``core.operators.moe``).

Training (JAX: GSPMD places the backward's collectives too): a shard keeps
its parameter's gradient flag; under autograd the output collectives are
differentiable (``comm_context.sum_over_group``, Megatron's *g*, and
``gather_from_group``); a block whose first projections are column-parallel
is marked (``mark_block_input``) so its training forward reads its input
through *f* (``comm_context.block_input``); and each parameter whose
gradient a rank holds only part of is recorded (``record_partial_grad``:
the q/k norms, a replicated kv head's rows, a rank-0-only bias) for
``parallel.training.finish_gradients``. An LM head whose logits are
gathered records its vocab shard (``mojo_vocab_shard``), which the model's
``lm_head_vocab`` gives the vocab-parallel loss.

``spec_for`` gives each parameter's JAX-style spec (a tuple of axis names
or None per dim; ``()`` for replicated) where the port shards the way JAX
does. A ``MojoMesh`` without groups (``MojoMesh.local``) slices for a rank
with identity collectives.
"""

from __future__ import annotations

import fnmatch
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from mojo_opset_tpu_torch.core.functions.loss import VocabShard
from mojo_opset_tpu_torch.core.operators.embedding import MojoEmbedding, MojoParallelEmbedding
from mojo_opset_tpu_torch.core.operators.gemm import INT4_BLOCK, MojoGemm, MojoQuantGemm
from mojo_opset_tpu_torch.core.operators.moe import EXPERT_MAJOR, MojoMoE, MojoQuantMoE
from mojo_opset_tpu_torch.core.operators.quantize import MojoDynamicQuant
from mojo_opset_tpu_torch.parallel.mesh import MojoMesh
from mojo_opset_tpu_torch.runtime import comm_context
from mojo_opset_tpu_torch.runtime.config import MojoParallelConfig
from mojo_opset_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

LINEAR = (MojoGemm, MojoQuantGemm)


# ---------------------------------------------------------------- slicing a linear op


def _set(module: nn.Module, name: str, value: torch.Tensor) -> None:
    """``module.name`` becomes ``value``, a parameter that keeps the gradient flag of the one it replaces."""
    trains = bool(getattr(getattr(module, name, None), "requires_grad", False))
    setattr(module, name, nn.Parameter(value.contiguous(), requires_grad=trains))


def _chunk(n: int, size: int, rank: int) -> torch.Tensor:
    return torch.arange(rank * n // size, (rank + 1) * n // size)


def _int4_rows(channels: torch.Tensor) -> Optional[torch.Tensor]:
    """The packed rows (``pack_int4_rows``: 128-channel blocks, two channels a
    byte) holding ``channels``, or None when they are not whole blocks."""
    if channels.numel() % INT4_BLOCK:
        return None
    blocks = channels.reshape(-1, INT4_BLOCK)
    first = blocks[:, :1]
    if (first % INT4_BLOCK).any() or not torch.equal(blocks, first + torch.arange(INT4_BLOCK)):
        return None
    half = INT4_BLOCK // 2
    return ((first // INT4_BLOCK) * half + torch.arange(half)).reshape(-1)


def can_select_out(op: nn.Module, channels: torch.Tensor) -> bool:
    return not (isinstance(op, MojoQuantGemm) and op.weight_dtype == "int4") or _int4_rows(channels) is not None


def select_out(op: nn.Module, channels: torch.Tensor) -> None:
    """Keep output ``channels`` of a ``MojoGemm`` / ``MojoQuantGemm`` (weight rows, bias, channel scales)."""
    dev = op.weight.device
    ch = channels.to(dev)
    if isinstance(op, MojoQuantGemm):
        if op.weight_dtype == "int4":
            _set(op, "weight", op.weight.index_select(0, _int4_rows(channels).to(dev)))
        else:
            _set(op, "weight", op.weight.index_select(0 if op.trans_weight else 1, ch))
        _set(op, "weight_scale", op.weight_scale.index_select(0, ch))
    else:
        _set(op, "weight", op.weight.index_select(0, ch))
        if op.bias is not None:
            _set(op, "bias", op.bias.index_select(0, ch))
    op.out_features = int(channels.numel())


def select_in(op: nn.Module, channels: torch.Tensor, keep_bias: bool = True) -> None:
    """Keep input ``channels`` of a linear op; its bias (whole) only where ``keep_bias``."""
    ch = channels.to(op.weight.device)
    dim = 0 if isinstance(op, MojoQuantGemm) and not op.trans_weight else 1
    _set(op, "weight", op.weight.index_select(dim, ch))
    if getattr(op, "bias", None) is not None and not keep_bias:
        _set(op, "bias", torch.zeros_like(op.bias))
        record_partial_grad(op, "bias", "zero")  # the sum adds rank 0's bias once; the others' zeros stay zero
    op.in_features = int(channels.numel())


def record_partial_grad(module: nn.Module, name: str, kind: str, group=None, head: Optional[Tuple[int, int]] = None
                        ) -> None:
    """Note on ``module`` that the gradient of its parameter ``name`` is not
    whole on this rank after the backward (``parallel.training``
    ``sum_partial_gradients`` completes it): ``"sum"`` over ``group``, a
    parameter every rank holds whole but reads for part of the work (the
    q/k norms, read by the rank's heads); ``"head"``, the rows of kv head
    ``head = (index, count)`` that several ranks of ``group`` hold (kv
    replication), summed over those; ``"zero"``, a bias kept on rank 0
    only, whose zeros elsewhere must not train."""
    if kind not in ("sum", "head", "zero"):
        raise ValueError(f"unknown partial gradient {kind!r}")
    module.__dict__.setdefault("mojo_partial_grads", []).append((name, kind, group, head))


def mark_block_input(block: nn.Module, group) -> None:
    """The block's input is replicated and its first projections column-parallel: its training forward reads the
    input through ``comm_context.block_input`` (Megatron's *f*), so the ranks' partial input gradients are summed."""
    block.mojo_input_group = group


class OutputCollective:
    """A forward hook: the collective a sharded module's output needs
    (``all_reduce`` of partial sums, or ``all_gather`` of column shards
    along ``dim``); under autograd their differentiable forms (the sum's
    backward the identity, the gather's this rank's block)."""

    def __init__(self, kind: str, group, dim: int = -1):
        if kind not in ("all_reduce", "all_gather"):
            raise ValueError(f"unknown output collective {kind!r}")
        self.kind, self.group, self.dim = kind, group, dim

    def __call__(self, module, args, output):
        if self.kind == "all_reduce":
            return comm_context.sum_over_group(output, self.group)
        return comm_context.gather_from_group(output, self.group, dim=self.dim)

    def __repr__(self):
        return f"OutputCollective({self.kind}, dim={self.dim})"


def install(module: nn.Module, kind: str, group, dim: int = -1) -> None:
    if hasattr(module, "mojo_output_collective"):
        raise ValueError(f"{type(module).__name__} already carries {module.mojo_output_collective}")
    hook = OutputCollective(kind, group, dim)
    module.mojo_output_collective = hook
    if group is not None:
        module.mojo_output_group = group  # seen by comm_context.model_groups
    module.register_forward_hook(hook)


def colwise(op: nn.Module, size: int, rank: int, group, gather_output: bool = False) -> bool:
    channels = _chunk(op.out_features, size, rank)
    if op.out_features % size or not can_select_out(op, channels):
        logger.warning("colwise: %s with %d outputs does not split over %d ranks; replicating",
                       type(op).__name__, op.out_features, size)
        return False
    total = op.out_features
    select_out(op, channels)
    if gather_output:
        install(op, "all_gather", group, -1)
        op.mojo_vocab_shard = VocabShard(group, int(channels[0]), total)  # what a vocab-parallel loss reads
    return True


def rowwise(op: nn.Module, size: int, rank: int, group) -> bool:
    if op.in_features % size:
        logger.warning("rowwise: %s with %d inputs does not split over %d ranks; replicating",
                       type(op).__name__, op.in_features, size)
        return False
    select_in(op, _chunk(op.in_features, size, rank), keep_bias=rank == 0)
    install(op, "all_reduce", group)
    return True


def _reduce_amax(block: nn.Module, group) -> None:
    """Every dynamic quant among ``block``'s children quantizes a rank's slice of each row."""
    for child in block.children():
        if isinstance(child, MojoDynamicQuant):
            child.amax_group = group


# ---------------------------------------------------------------- heads


def head_plan(num_heads: int, num_kv_heads: int, size: int, rank: int, layout: str = "AABB"
              ) -> Tuple[List[int], List[int]]:
    """The query heads and the kv heads that rank ``rank`` of ``size`` keeps,
    in the order its attention reads them; ValueError where whole heads do
    not split."""
    H, Hkv = num_heads, num_kv_heads
    if layout not in ("AABB", "ABAB"):
        raise ValueError(f"unknown gqa layout {layout!r}")
    if H % Hkv or H % size or (Hkv % size if size <= Hkv else size % Hkv):
        raise ValueError(f"{H} query and {Hkv} kv heads do not split over {size} ranks")
    if size <= Hkv:
        kvl = Hkv // size
        kv = list(range(rank * kvl, (rank + 1) * kvl))
    else:
        kv = [rank // (size // Hkv)]
    if layout == "AABB":
        hl = H // size
        return list(range(rank * hl, (rank + 1) * hl)), kv
    groups = H // Hkv
    if size <= Hkv:
        return [g * Hkv + k for g in range(groups) for k in kv], kv
    rep = size // Hkv
    if groups % rep:
        raise ValueError(f"{H} query and {Hkv} kv heads do not split over {size} ranks under ABAB")
    gl, sub = groups // rep, rank % rep
    return [g * Hkv + kv[0] for g in range(sub * gl, (sub + 1) * gl)], kv


def _head_channels(heads: Sequence[int], head_dim: int) -> torch.Tensor:
    return (torch.as_tensor(heads)[:, None] * head_dim + torch.arange(head_dim)).reshape(-1)


def shard_attention(attn: nn.Module, size: int, rank: int, group, layout: str = "AABB") -> bool:
    """Whole heads of an attention block (``q_proj``, ``k_proj``, ``v_proj``,
    ``o_proj``, ``num_heads``, ``num_kv_heads``, ``head_dim``): the rank's
    query heads and the kv heads they read, ``o_proj`` row-parallel over the
    same heads, the dynamic quant before it (if any) on the row's amax.
    False (and the block left whole) where heads do not split."""
    try:
        q_heads, kv_heads = head_plan(attn.num_heads, attn.num_kv_heads, size, rank, layout)
    except ValueError as err:
        logger.warning("attention: %s; replicating", err)
        return False
    q_ch, kv_ch = _head_channels(q_heads, attn.head_dim), _head_channels(kv_heads, attn.head_dim)
    if not (can_select_out(attn.q_proj, q_ch) and can_select_out(attn.k_proj, kv_ch)
            and can_select_out(attn.v_proj, kv_ch)):
        logger.warning("attention: packed-int4 projections hold other heads in one 128-channel block; replicating")
        return False
    select_out(attn.q_proj, q_ch)
    select_out(attn.k_proj, kv_ch)
    select_out(attn.v_proj, kv_ch)
    select_in(attn.o_proj, q_ch, keep_bias=rank == 0)
    install(attn.o_proj, "all_reduce", group)
    _reduce_amax(attn, group)
    mark_block_input(attn, group)
    for norm in (getattr(attn, "q_norm", None), getattr(attn, "k_norm", None)):
        if norm is not None:  # shared by all heads; a rank's gradient covers its own heads
            record_partial_grad(norm, "weight", "sum", group)
    if size > attn.num_kv_heads:  # kv replication: each holder's queries give part of the head's dK and dV
        for proj in (attn.k_proj, attn.v_proj):
            for name, _ in proj.named_parameters(recurse=False):
                record_partial_grad(proj, name, "head", group, (kv_heads[0], attn.num_kv_heads))
    attn.num_heads, attn.num_kv_heads = len(q_heads), len(kv_heads)
    return True


def shard_mlp(mlp: nn.Module, size: int, rank: int, group, col=("gate_proj", "up_proj"), row=("down_proj",)
              ) -> bool:
    """Megatron's MLP: ``col`` column-parallel, ``row`` row-parallel on the same channels, the dynamic quant
    between them on the row's amax."""
    width = getattr(mlp, row[0]).in_features
    channels = _chunk(width, size, rank)
    if width % size or not all(can_select_out(getattr(mlp, n), channels) for n in col):
        logger.warning("mlp: width %d does not split over %d ranks; replicating", width, size)
        return False
    for name in col:
        select_out(getattr(mlp, name), channels)
    for name in row:
        select_in(getattr(mlp, name), channels, keep_bias=rank == 0)
        install(getattr(mlp, name), "all_reduce", group)
    _reduce_amax(mlp, group)
    mark_block_input(mlp, group)
    return True


def shard_swiglu(mlp: nn.Module, size: int, rank: int, group) -> bool:
    """A fused SwiGLU MLP (``fc1`` gate rows then up rows, ``fc2``): the rank's channels of each half."""
    width = mlp.fc2.in_features
    if width % size:
        logger.warning("swiglu: width %d does not split over %d ranks; replicating", width, size)
        return False
    channels = _chunk(width, size, rank)
    select_out(mlp.fc1, torch.cat([channels, channels + width]))
    select_in(mlp.fc2, channels, keep_bias=rank == 0)
    install(mlp.fc2, "all_reduce", group)
    mark_block_input(mlp, group)
    return True


def shard_embedding(embedding: MojoEmbedding, size: int, rank: int, group) -> MojoParallelEmbedding:
    return MojoParallelEmbedding.from_embedding(embedding, group=group, num_shards=size, shard=rank)


def is_attention(module: nn.Module) -> bool:
    return all(hasattr(module, a) for a in ("q_proj", "k_proj", "v_proj", "o_proj", "num_heads", "num_kv_heads",
                                            "head_dim"))


def _linears(module: nn.Module) -> list:
    return [m for m in module.modules() if isinstance(m, LINEAR)]


def axis_of(mesh: MojoMesh, axis: str) -> Tuple[int, int, object]:
    return mesh.size(axis), mesh.rank(axis), mesh.group(axis)


# ---------------------------------------------------------------- styles


class MojoParallelStyle:
    """Base: ``spec_for(name, param, mesh)`` gives a parameter's JAX-style
    spec, ``apply(module, mesh)`` shards the module in place (and returns
    it, or the module that takes its place)."""

    axis: str = "tp"

    def __init__(self, axis: Optional[str] = None):
        if axis is not None:
            self.axis = axis

    def spec_for(self, name: str, param: torch.Tensor, mesh: MojoMesh) -> tuple:
        raise NotImplementedError

    def apply(self, module: nn.Module, mesh: MojoMesh) -> nn.Module:
        raise NotImplementedError(f"{type(self).__name__} has no apply")


class MojoColwiseParallel(MojoParallelStyle):
    """Column-parallel linear ops (weight (out, in) split on out; bias and
    channel scales with it); ``gather_output`` all-gathers the output."""

    def __init__(self, axis: Optional[str] = None, gather_output: bool = False):
        super().__init__(axis)
        self.gather_output = gather_output

    def spec_for(self, name, param, mesh):
        if name.endswith(".weight") and param.ndim == 2:
            return (self.axis, None)
        if name.endswith((".bias", ".weight_scale")) and param.ndim == 1:
            return (self.axis,)
        return ()

    def apply(self, module, mesh):
        for op in _linears(module):
            colwise(op, *axis_of(mesh, self.axis), gather_output=self.gather_output)
        return module


class MojoRowwiseParallel(MojoParallelStyle):
    """Row-parallel linear ops (weight (out, in) split on in), the output summed over the group."""

    def spec_for(self, name, param, mesh):
        if name.endswith(".weight") and param.ndim == 2:
            return (None, self.axis)
        return ()

    def apply(self, module, mesh):
        for op in _linears(module):
            rowwise(op, *axis_of(mesh, self.axis))
        return module


class MojoQKVColwiseParallel(MojoParallelStyle):
    """An attention block split by whole heads (``shard_attention``);
    ``o_proj`` row-parallel over the rank's heads."""

    def __init__(self, num_heads: int, num_kv_heads: int, axis: Optional[str] = None, gqa_layout: str = "AABB"):
        super().__init__(axis)
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.gqa_layout = gqa_layout

    def spec_for(self, name, param, mesh):
        tp = mesh.size(self.axis)
        shard_kv = tp <= self.num_kv_heads and self.num_kv_heads % tp == 0
        shard = ("q_proj" in name) or (shard_kv and any(k in name for k in ("k_proj", "v_proj")))
        if shard and name.endswith(".weight") and param.ndim == 2:
            return (self.axis, None)
        if shard and name.endswith((".bias", ".weight_scale")):
            return (self.axis,)
        if "o_proj" in name and name.endswith(".weight") and param.ndim == 2:
            return (None, self.axis)
        return ()

    def apply(self, module, mesh):
        if (module.num_heads, module.num_kv_heads) != (self.num_heads, self.num_kv_heads):
            raise ValueError(f"the style is for {self.num_heads}/{self.num_kv_heads} heads, the module has "
                             f"{module.num_heads}/{module.num_kv_heads}")
        shard_attention(module, *axis_of(mesh, self.axis), layout=self.gqa_layout)
        return module


class MojoSwiGLUParallel(MojoParallelStyle):
    """A fused SwiGLU MLP: ``fc1``'s gate and up halves each split on its own, ``fc2`` row-parallel."""

    def spec_for(self, name, param, mesh):
        if "fc1" in name and name.endswith(".weight") and param.ndim == 2:
            return (self.axis, None)  # of each half
        if "fc2" in name and name.endswith(".weight") and param.ndim == 2:
            return (None, self.axis)
        return ()

    def apply(self, module, mesh):
        shard_swiglu(module, *axis_of(mesh, self.axis))
        return module


class MojoTensorParallel(MojoParallelStyle):
    """Megatron's pairing in a block: an attention block by heads
    (``shard_attention``), a fused SwiGLU by halves, else the ``COL``
    children column-parallel and the ``ROW`` children row-parallel."""

    COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "fc1")
    ROW = ("o_proj", "down_proj", "fc2")

    def spec_for(self, name, param, mesh):
        if param.ndim == 2 and name.endswith(".weight"):
            if any(k in name for k in self.COL):
                return (self.axis, None)
            if any(k in name for k in self.ROW):
                return (None, self.axis)
        if param.ndim == 1 and name.endswith((".bias", ".weight_scale")) and any(k in name for k in self.COL):
            return (self.axis,)
        return ()

    def apply(self, module, mesh):
        size, rank, group = axis_of(mesh, self.axis)
        if is_attention(module):
            shard_attention(module, size, rank, group)
        elif hasattr(module, "fc1") and hasattr(module, "fc2"):
            shard_swiglu(module, size, rank, group)
        else:
            col = tuple(n for n, _ in module.named_children() if n in self.COL)
            row = tuple(n for n, _ in module.named_children() if n in self.ROW)
            if row:
                shard_mlp(module, size, rank, group, col, row)
            else:
                for name in col:
                    colwise(getattr(module, name), size, rank, group)
        return module


class MojoDataParallel(MojoParallelStyle):
    """Data parallelism: weights stay whole on every rank (JAX: pure input/output resharding)."""

    axis = "dp"

    def spec_for(self, name, param, mesh):
        return ()

    def apply(self, module, mesh):
        return module


class MojoExpertParallel(MojoParallelStyle):
    """Expert parallelism of a ``MojoMoE`` / ``MojoQuantMoE``: the rank's
    experts (every ``EXPERT_MAJOR`` tensor on dim 0; an uneven split gives
    the first ranks one more), the outputs summed over the group
    (``dp_input``: tokens gathered in, output reduce-scattered)."""

    axis = "ep"

    def __init__(self, axis: Optional[str] = None, dp_input: bool = False):
        super().__init__(axis)
        self.dp_input = dp_input

    def spec_for(self, name, param, mesh):
        if name.rpartition(".")[2] in EXPERT_MAJOR and param.ndim >= 2:
            return (self.axis,) + (None,) * (param.ndim - 1)
        return ()

    def apply(self, module, mesh):
        moes = [m for m in module.modules() if isinstance(m, (MojoMoE, MojoQuantMoE))]
        if not moes:
            raise ValueError(f"MojoExpertParallel: no MoE in {type(module).__name__}")
        size, rank, group = axis_of(mesh, self.axis)
        for moe in moes:
            moe.shard_experts(size, rank, group, dp_input=self.dp_input)
        return module


class MojoRegisterableParallelStyle(MojoParallelStyle):
    """A style with a per-module-class registry of how to shard (JAX :183,
    the reference's ``register_dist_info``): ``partition_fn(module, mesh)``
    shards and returns the module; ``prepare_input_fn(mesh, args, kwargs)``
    and ``prepare_output_fn(mesh, output)`` wrap its forward, or, without
    them, the desired layouts (JAX-style specs) do: a replicated first input
    is cut to the rank's block along each sharded dim of
    ``desired_input_layouts``, and an output sharded as
    ``desired_output_layouts`` says is all-gathered back to whole. Each
    subclass has a registry of its own."""

    dist_info_map: Dict[type, tuple] = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls.dist_info_map = {}

    @classmethod
    def register_dist_info(cls, module_clses, partition_fn=None, prepare_input_fn=None, prepare_output_fn=None,
                           desired_input_layouts=None, desired_output_layouts=None):
        if not isinstance(module_clses, tuple):
            module_clses = (module_clses,)
        for module_cls in module_clses:
            cls.dist_info_map[module_cls] = (partition_fn, prepare_input_fn, prepare_output_fn,
                                             desired_input_layouts, desired_output_layouts)

    @classmethod
    def get_dist_info(cls, module_cls):
        for klass in module_cls.__mro__:
            if klass in cls.dist_info_map:
                return cls.dist_info_map[klass]
        return None

    def apply(self, module, mesh):
        info = self.get_dist_info(type(module))
        if info is None:
            return super().apply(module, mesh)
        sharded = info[0](module, mesh) if info[0] is not None else module
        return _DistInfoWrapped(sharded, mesh, info)


def _shard_input(value, mesh: MojoMesh, layout):
    for dim, axis in enumerate(layout or ()):
        if axis is not None:
            size, rank = mesh.size(axis), mesh.rank(axis)
            value = value.narrow(dim, rank * value.shape[dim] // size, value.shape[dim] // size)
    return value


def _gather_output(value, mesh: MojoMesh, layout):
    for dim, axis in enumerate(layout or ()):
        if axis is not None:
            value = comm_context.all_gather(value, mesh.group(axis), dim=dim)
    return value


class _DistInfoWrapped(nn.Module):
    """A registered module with its prepare functions (or layouts) around its forward."""

    def __init__(self, module: nn.Module, mesh: MojoMesh, info: tuple):
        super().__init__()
        self.module = module
        self.mesh = mesh
        _, self._prep_in, self._prep_out, self._in_layouts, self._out_layouts = info

    def forward(self, *args, **kwargs):
        if self._prep_in is not None:
            args, kwargs = self._prep_in(self.mesh, args, kwargs)
        elif self._in_layouts is not None and args:
            args = (_shard_input(args[0], self.mesh, self._in_layouts),) + tuple(args[1:])
        out = self.module(*args, **kwargs)
        if self._prep_out is not None:
            return self._prep_out(self.mesh, out)
        return _gather_output(out, self.mesh, self._out_layouts)


class MojoDistributedModule(nn.Module):
    """A module with the style that sharded it, recording which parameters
    the style manages (JAX :262; for checkpoint tooling)."""

    def __init__(self, module: nn.Module, style: MojoParallelStyle):
        super().__init__()
        self.module = module
        self.style = style
        self._managed_params = [name for name, _ in module.named_parameters()]

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)

    def get_unmanaged_params(self, model: nn.Module) -> list:
        managed = tuple(self._managed_params)
        return [name for name, _ in model.named_parameters() if not name.endswith(managed)]


def record_parallel(model: nn.Module, mesh: MojoMesh) -> nn.Module:
    """Note on ``model`` what sharding changed, for its config
    (``runtime.config.sharded_config``): the parallel sizes and the kv
    heads of one rank's attention."""
    attention = [m for m in model.modules() if is_attention(m)]
    shape = mesh.shape
    model.mojo_parallel = {
        "parallel_config": MojoParallelConfig(PP_SIZE=shape.get("pp", 1), ATTN_DP_SIZE=shape.get("dp", 1),
                                              ATTN_SP_SIZE=shape.get("sp", 1), ATTN_TP_SIZE=shape.get("tp", 1),
                                              FFN_EP_SIZE=shape.get("ep", 1)),
        "local_num_kv_heads": attention[0].num_kv_heads if attention else None,
    }
    return model


def replace_module(model: nn.Module, name: str, new: nn.Module) -> None:
    parent, _, attr = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, attr, new)


def mojo_parallelize_module(model: nn.Module, mesh: MojoMesh, plan: Dict[str, MojoParallelStyle]) -> nn.Module:
    """Apply a ``{pattern: style}`` plan: each submodule whose path matches
    ``*pattern*`` (the outermost match; the first pattern that matches) is
    sharded by its style, in place; the rest stays whole. Returns ``model``."""
    done: List[str] = []
    for name, module in list(model.named_modules()):
        if not name or any(name.startswith(d + ".") for d in done):
            continue
        for pattern, style in plan.items():
            if fnmatch.fnmatch(name, f"*{pattern}*"):
                new = style.apply(module, mesh)
                if new is not module:
                    replace_module(model, name, new)
                done.append(name)
                break
    return record_parallel(model, mesh)
