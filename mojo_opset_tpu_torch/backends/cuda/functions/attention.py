"""cuda-tier training attention: kernel J (``csrc/flash_swa.cu``) forward
and backward under one ``torch.autograd.Function``.

Counterpart of the JAX package's ``backends/pallas/functions/attention.py:23``
(``PallasSWAFunction`` over ``flash_swa``'s ``jax.custom_vjp``). The
forward runs J's forward and saves ``(q, k, v, o, lse)``; the backward runs
J's dq kernel (which also writes ``delta = rowsum(do * o)``) and then its
dk/dv kernel. None of the TPU tier's detours is carried over: no
``D % 128`` gate, no f16 -> fp32 upcast, no batch cap, no golden for
``ABAB`` (J takes both layouts). What J does not take raises.

J needs no ``aligned`` hint (JAX :44): each of its blocks bounds the keys
(or queries) it walks by its own rows' sequences and positions, which is
exact whether ``cu_q_lens`` and ``cu_total_seq_lens`` are one vector or not.
"""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.flash_swa import flash_swa_bwd, flash_swa_fwd
from mojo_opset_tpu_torch.core.functions.attention import MojoSWAFunction


class FlashSWA(torch.autograd.Function):
    """``apply(q, k, v, cu_q, cu_k, cfg, fwd, bwd)``: ``fwd``/``bwd`` are
    J's dispatching wrappers (a plain twin passes the plain versions);
    ``cfg`` holds causal, the windows, the scale and the GQA layout."""

    @staticmethod
    def forward(ctx, q, k, v, cu_q, cu_k, cfg, fwd, bwd):
        o, lse = fwd(q, k, v, cu_q, cu_k, **cfg)
        ctx.save_for_backward(q, k, v, o, lse, cu_q, cu_k)
        ctx.cfg, ctx.bwd = cfg, bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, cu_q, cu_k = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, lse, do.contiguous(), cu_q, cu_k, **ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(query, key, value, cu_q_lens, cu_total_seq_lens, is_causal=True, local_window_size=None,
                    global_window_size=None, softmax_scale: Optional[float] = None, gqa_layout="AABB",
                    fwd=flash_swa_fwd, bwd=flash_swa_bwd) -> torch.Tensor:
    """Packed varlen attention on kernel J, differentiable in q, k and v."""
    cfg = dict(causal=is_causal, local_window=local_window_size, global_window=global_window_size,
               scale=softmax_scale, gqa_layout=gqa_layout)
    return FlashSWA.apply(query.contiguous(), key.contiguous(), value.contiguous(), cu_q_lens, cu_total_seq_lens,
                          cfg, fwd, bwd)


class CudaSWAFunction(MojoSWAFunction):
    """Its ``swa`` op is ``CudaSWA``, which runs ``FlashSWA``."""
