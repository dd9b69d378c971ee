"""Process groups for the parallel axes.

Counterpart of the JAX package's ``parallel/mesh.py`` (``build_mesh`` :22,
``mesh_from_parallel_config`` :31, ``local_mesh_for_role`` :64). A JAX
``Mesh`` names device axes; here a ``MojoMesh`` gives this process, for
each axis, its coordinate, the axis's size and the ``torch.distributed``
group of the ranks that differ from it along that axis alone. Every rank
builds the same mesh, since creating a group is a collective call over
the whole world.

``init_distributed`` starts the world: the backend follows the device
(``cuda`` -> NCCL, ``cpu`` -> gloo) unless the caller names one (gloo on
the card carries ranks that share one card, which NCCL refuses), and a
failure raises; nothing falls back to another backend or device.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mojo_opset_tpu_torch.runtime.config import AFDRole, MojoParallelConfig
from mojo_opset_tpu_torch.utils.platform import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(rank: int, world_size: int, init_method: str, device=None,
                     timeout: Optional[timedelta] = None, backend: Optional[str] = None) -> torch.device:
    """Join the world as ``rank`` of ``world_size`` through ``init_method``
    (``tcp://host:port`` or ``file:///path``) on ``device`` (the card unless
    another is named); returns the device. NCCL's communicator is bound to
    the card here, so a fault shows at once."""
    device = resolve_device(device)
    backend = backend or BACKENDS.get(device.type)
    if backend is None:
        raise ValueError(f"no collective backend for device {device}")
    kwargs = {} if timeout is None else {"timeout": timeout}
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size, **kwargs)
    return device


@dataclass
class MojoMesh:
    """This rank's view of a mesh: axis sizes, its coordinate on each axis
    and the group of each axis (None where no process group was built: a
    view for slicing weights alone, whose collectives are identities)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object] = field(default_factory=dict)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def rank(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups.get(axis)

    @classmethod
    def local(cls, shape: Dict[str, int], coords: Dict[str, int]) -> "MojoMesh":
        """A mesh with no process groups: what a style slices for the rank at ``coords``."""
        return cls(dict(shape), dict(coords))


def build_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str], ranks: Optional[Sequence[int]] = None
               ) -> Optional[MojoMesh]:
    """The mesh over ``ranks`` (default: the whole world) laid out row-major
    as ``axis_sizes``. Every rank of the world must call it (groups are made
    collectively); a rank outside ``ranks`` gets None."""
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    total = int(np.prod(axis_sizes))
    if total > len(ranks):
        raise ValueError(f"mesh needs {total} ranks, have {len(ranks)}")
    grid = np.array(ranks[:total]).reshape(tuple(axis_sizes))
    me = dist.get_rank()
    where = np.argwhere(grid == me)
    coords = dict(zip(axis_names, (int(c) for c in where[0]))) if len(where) else None
    groups = {}
    for a, name in enumerate(axis_names):
        others = [range(s) for i, s in enumerate(axis_sizes) if i != a]
        for fixed in itertools.product(*others):
            index = list(fixed)
            index.insert(a, slice(None))
            members = [int(r) for r in grid[tuple(index)]]
            group = dist.new_group(members)
            if me in members:
                groups[name] = group
    if coords is None:
        return None
    return MojoMesh(dict(zip(axis_names, axis_sizes)), coords, groups)


def mesh_from_parallel_config(config: MojoParallelConfig, ranks: Optional[Sequence[int]] = None
                              ) -> Tuple[Optional[MojoMesh], Optional[MojoMesh]]:
    """Non-AFD: one mesh (pp, dp, sp, tp) and None. AFD: the attention mesh
    (pp, dp, sp, tp) over the first ``attn_world_size`` ranks and the FFN
    mesh (pp, ep, tp) over the next ``ffn_world_size``; a rank gets None for
    the mesh it is not in."""
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    if not config.AFD_ENABLED:
        mesh = build_mesh((config.PP_SIZE, config.ATTN_DP_SIZE, config.ATTN_SP_SIZE, config.ATTN_TP_SIZE),
                          ("pp", "dp", "sp", "tp"), ranks)
        return mesh, None
    attn_n = config.attn_world_size
    attn = build_mesh((config.ATTN_PP_SIZE, config.ATTN_DP_SIZE, config.ATTN_SP_SIZE, config.ATTN_TP_SIZE),
                      ("pp", "dp", "sp", "tp"), ranks[:attn_n])
    ffn = build_mesh((config.FFN_PP_SIZE, config.FFN_EP_SIZE, config.FFN_TP_SIZE), ("pp", "ep", "tp"),
                     ranks[attn_n:attn_n + config.ffn_world_size])
    return attn, ffn


def local_mesh_for_role(config: MojoParallelConfig, role: AFDRole, ranks: Optional[Sequence[int]] = None
                        ) -> Optional[MojoMesh]:
    attn, ffn = mesh_from_parallel_config(config, ranks)
    if not config.AFD_ENABLED:
        return attn
    return attn if role == AFDRole.ATTN else ffn
