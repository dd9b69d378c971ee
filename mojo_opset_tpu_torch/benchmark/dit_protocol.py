"""Wan2.2 DiT denoise-step timing protocol on the card.

Counterpart of the JAX package's ``benchmark/dit_protocol.py``
(``dit_step_flops`` :30, ``PerfDiTRunner`` :48): one denoise step is a DiT
forward and an Euler update, with the latents fed back so consecutive steps
depend on each other, as in a sampler loop. Step time comes from CUDA events
around ``steps`` steps (the caller warms the model up first); a model that is
not on the card raises (no CPU timing is reported as a device time).
``chip_smoke.py`` phase 12 times Wan2.2-TI2V-5B's steps with ``denoise``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def dit_step_flops(cfg, seq_len: int, text_len: int) -> float:
    """FLOPs of one DiT forward at ``seq_len`` latent tokens against
    ``text_len`` context tokens: each block's self-attention projections and
    scores, cross-attention, and two-matmul FFN (patch embed, head and
    modulation are O(L * dim) and ignored). 1 MAC = 2 FLOPs."""
    d, f, n = cfg.dim, cfg.ffn_dim, cfg.num_layers
    L, T = seq_len, text_len
    self_attn = 4 * L * d * d + 2 * L * L * d
    cross_attn = (2 * L + 2 * T) * d * d + 2 * L * T * d
    ffn = 2 * L * d * f
    return 2.0 * n * (self_attn + cross_attn + ffn)


def denoise_step(model, x: List[torch.Tensor], t: torch.Tensor, context: List[torch.Tensor], seq_len: int,
                 dt: float) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One Euler step of every latent: ``(x + velocity * dt, velocity)``."""
    velocity = model(x, t, context, seq_len=seq_len)
    return [u + w * dt for u, w in zip(x, velocity)], velocity


class PerfDiTRunner:
    """Time the DiT denoise step of ``model`` on the card."""

    def __init__(self, model):
        self.model = model

    @torch.inference_mode()
    def denoise(self, xs: List[torch.Tensor], context: List[torch.Tensor], seq_len: int, steps: int):
        """``steps`` Euler steps of the latents ``xs`` from t = 999 towards 0,
        the latents fed back: the first step's velocities, the final latents
        and the ms a step from CUDA events."""
        device = self.model.patch_weight.device
        if device.type != "cuda":
            raise RuntimeError(f"PerfDiTRunner times the card; the model is on {device}")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        first = None
        start.record()
        for i in range(steps):
            t = torch.full((len(xs),), 999.0 * (1 - i / steps), device=device)
            xs, velocity = denoise_step(self.model, xs, t, context, seq_len, -1.0 / steps)
            first = velocity if first is None else first
        end.record()
        torch.cuda.synchronize()
        return first, xs, start.elapsed_time(end) / steps
