"""Runtime parallel helpers: the token exchange between a data-parallel
attention group and a shared FFN (attention-FFN disaggregation).

Counterpart of the JAX package's ``runtime/parallel.py`` (``dp_allreduce``
:18, ``dp_scatter`` :25, ``dp_gather`` :32, ``merge_group_and_share_ffn``
:39): ``torch.distributed`` collectives over the DP group
(``runtime.comm_context``) in place of ``jax.lax`` axis collectives;
``group=None`` is the identity.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.runtime import comm_context


def dp_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum partial activations across the DP group."""
    return comm_context.all_reduce(x, group)


def dp_scatter(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """Reduce-scatter the ``axis`` dim back to the DP ranks' shards."""
    return comm_context.reduce_scatter(x, group, dim=axis)


def dp_gather(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """All-gather the DP ranks' shards, so the FFN side sees every token."""
    return comm_context.all_gather(x, group, dim=axis)


def merge_group_and_share_ffn(hidden: torch.Tensor, dp_group, ffn_fn) -> torch.Tensor:
    """Gather the DP group's tokens, run the shared FFN once over them, and
    reduce-scatter the result back (JAX :39-49)."""
    return dp_scatter(ffn_fn(dp_gather(hidden, dp_group, axis=0)), dp_group, axis=0)
