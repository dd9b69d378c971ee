"""Per-rank save and load of a sharded model's state.

Counterpart of the JAX package's ``parallel/checkpoint.py`` (``state_dict``
:28, ``stat_dict_rename_hook`` :34, ``mojo_parallel_save_state_dict_naive``
:47, ``mojo_parallel_load_state_dict_naive`` :66). A JAX array carries its
sharding and process 0 sees the whole logical array, so JAX saves one
gathered file. A port rank holds plain local tensors, its own shards, so
each rank saves its own state (the naive per-rank form) to its own path,
its keys marked with its mesh coordinates by ``stat_dict_rename_hook``
(``weight`` -> ``weight@ep1,tp0``), and loads it back into a model sharded
the same way.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from mojo_opset_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def state_dict(model: nn.Module) -> dict:
    """Flat ``{name: np.ndarray}`` of this rank's parameters and buffers (bf16 widened to fp32)."""
    out = {}
    for name, t in model.state_dict().items():
        t = t.detach().cpu()
        out[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def stat_dict_rename_hook(mesh_coords: dict) -> Callable[[str], str]:
    """Key renamer appending the mesh coordinates: ``weight`` -> ``weight@tp0,ep1`` (axes sorted)."""
    suffix = ",".join(f"{k}{v}" for k, v in sorted(mesh_coords.items()))

    def rename(key: str) -> str:
        return f"{key}@{suffix}" if suffix else key

    return rename


def mojo_parallel_save_state_dict_naive(model: nn.Module, path: str, mesh_coords: Optional[dict] = None,
                                        rename_hook: Optional[Callable[[str], str]] = None) -> None:
    """Save this rank's state to ``path`` (each rank its own path)."""
    sd = state_dict(model)
    if rename_hook is None and mesh_coords:
        rename_hook = stat_dict_rename_hook(mesh_coords)
    if rename_hook is not None:
        sd = {rename_hook(k): v for k, v in sd.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(sd, f)
    logger.info("saved %d tensors to %s", len(sd), path)


@torch.no_grad()
def mojo_parallel_load_state_dict_naive(model: nn.Module, path: str, rename_hook: Optional[Callable[[str], str]] = None,
                                        strict: bool = True) -> nn.Module:
    """Load a saved state into ``model`` (sharded as the saving rank was), in
    place; a shape that differs raises, a missing key raises unless
    ``strict`` is off (then the model keeps its value)."""
    with open(path, "rb") as f:
        sd = pickle.load(f)
    missing = []
    for name, t in model.state_dict().items():
        key = rename_hook(name) if rename_hook is not None else name
        if key not in sd:
            missing.append(key)
            continue
        value = np.asarray(sd[key])
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint shape mismatch for {key}: {tuple(value.shape)} vs model {tuple(t.shape)}")
        t.copy_(torch.from_numpy(value).to(t.dtype))
    if missing and strict:
        raise KeyError(f"missing keys in checkpoint: {missing[:10]} (+{max(0, len(missing) - 10)} more)")
    if missing:
        logger.warning("checkpoint missing %d keys; kept existing values", len(missing))
    return model
