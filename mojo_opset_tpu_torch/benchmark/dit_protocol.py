"""Wan2.2 DiT denoise-step timing protocol.

Counterpart of the JAX package's ``benchmark/dit_protocol.py``
(``dit_step_flops`` :30, ``PerfDiTRunner`` :48, ``run_dit_perf`` :119, the
CLI :142): one denoise step is a DiT forward and an Euler update, with the
latents fed back so consecutive steps depend on each other, as in a sampler
loop. ``PerfDiTRunner.run`` sweeps latent geometries and times the step
through ``benchmark/timing.py`` (a chain of steps, ``x`` fed back; on the
card CUDA events, from a CUDA graph where the step never syncs the host;
the host clock on the CPU, its records saying ``"timer": "host"``).
``denoise`` times ``steps`` steps with CUDA events and raises off the card;
``chip_smoke.py`` phase 12 times Wan2.2-TI2V-5B's steps with it.

Usage (the card)::

    python -m mojo_opset_tpu_torch.benchmark.dit_protocol [--dim 2048] [--layers 32]
        [--steps 4] [--sizes '1,32,32;5,60,104']
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import torch

from mojo_opset_tpu_torch.utils.logging import get_logger, log_table

logger = get_logger(__name__)


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
    """Time the DiT denoise step of ``model``.

    ``run`` records one row a latent geometry ``(F, H, W)`` (after the
    VAE, before patchifying): its token count, ms a step and TFLOP/s
    through the backbone, against ``text_tokens`` context rows."""

    # (frames, H, W) after the VAE's 8x spatial downsampling: 32 x 32 is
    # a ~256 px image, (5, 60, 104) a 17-frame 480 x 832 clip
    SIZES: Tuple[Tuple[int, int, int], ...] = ((1, 32, 32), (1, 60, 104), (5, 60, 104))

    def __init__(self, model, text_tokens: int = 64, seed: int = 0):
        self.model = model
        self.text_tokens = min(text_tokens, model.cfg.text_len)
        self.seed = seed

    def _case_inputs(self, size: Tuple[int, int, int]):
        """The latent (in_dim, F, H, W) and context (text_tokens, text_dim),
        fp32 from a generator seeded ``seed`` on the model's device, and the
        token count."""
        cfg = self.model.cfg
        F, H, W = size
        pt, ph, pw = cfg.patch_size
        if F % pt or H % ph or W % pw:
            raise ValueError(f"latent {size} not divisible by patch_size {cfg.patch_size}")
        seq_len = (F // pt) * (H // ph) * (W // pw)
        device = self.model.patch_weight.device
        gen = torch.Generator(device=device).manual_seed(self.seed)
        x = torch.randn((cfg.in_dim, F, H, W), generator=gen, device=device)
        ctx = torch.randn((self.text_tokens, cfg.text_dim), generator=gen, device=device)
        return x, ctx, seq_len

    @torch.inference_mode()
    def run(self, sizes: Optional[Iterable[Tuple[int, int, int]]] = None, steps: int = 4) -> List[dict]:
        from mojo_opset_tpu_torch.benchmark.timing import timed_us

        records: List[dict] = []
        for size in sizes or self.SIZES:
            x, ctx, seq_len = self._case_inputs(size)
            dt = -1.0 / max(steps, 1)
            t = torch.full((1,), 999.0, device=x.device)

            def step(x):
                return denoise_step(self.model, [x], t, [ctx], seq_len, dt)[0][0]

            us, timer = timed_us(step, x, iters=max(steps, 2), thread_idx=((0, 0),))
            ms = us / 1e3
            flops = dit_step_flops(self.model.cfg, seq_len, self.text_tokens)
            records.append({"latent": tuple(size), "tokens": seq_len, "denoise_ms": ms,
                            "tflops": flops / (ms * 1e-3) / 1e12, "timer": timer})

        log_table(logger, "=" * 68)
        log_table(logger, f"{'DiT Denoise Step Latency':^68}")
        log_table(logger, f"{'Latent (F,H,W)':<16} | {'Tokens':<8} | {'ms/step':<10} | {'TFLOP/s':<10} | timer")
        for r in records:
            log_table(logger, f"{str(r['latent']):<16} | {r['tokens']:<8} | {r['denoise_ms']:<10.2f} | "
                              f"{r['tflops']:<10.1f} | {r['timer']}")
        return records

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


def run_dit_perf(dim: int = 2048, layers: int = 32, sizes=None, steps: int = 4, seed: int = 0,
                 dtype: torch.dtype = torch.bfloat16, device=None) -> List[dict]:
    """A Wan DiT of random weights (seeded; weights do not change the time)
    at ``dim`` wide and ``layers`` deep, its parameters in ``dtype`` (bf16:
    the serving cast; the latents stay fp32 at the boundary), built on the
    card unless ``device`` names another, through ``PerfDiTRunner.run``."""
    from mojo_opset_tpu_torch.modeling.wan2_2 import WanConfig, WanModel
    from mojo_opset_tpu_torch.utils.platform import resolve_device

    cfg = WanConfig(patch_size=(1, 2, 2), text_len=512, in_dim=16, dim=dim, ffn_dim=dim * 4, freq_dim=256,
                    text_dim=4096, out_dim=16, num_heads=max(dim // 128, 1), num_layers=layers, dtype=dtype)
    device = resolve_device(device)
    model = WanModel(cfg, device=device, generator=torch.Generator(device=device).manual_seed(seed))
    return PerfDiTRunner(model, seed=seed).run(sizes=sizes, steps=steps)


def main(argv=None) -> List[dict]:
    import argparse
    import json

    p = argparse.ArgumentParser(description="Time the Wan DiT denoise step at latent geometries")
    p.add_argument("--dim", type=int, default=2048)
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--sizes", default=None, help="semicolon list of F,H,W triples, e.g. '1,32,32;5,60,104'")
    p.add_argument("--device", default=None, help="the card unless named (cpu: host-clock times)")
    args = p.parse_args(argv)
    sizes = [tuple(int(v) for v in s.split(",")) for s in args.sizes.split(";")] if args.sizes else None
    records = run_dit_perf(args.dim, args.layers, sizes=sizes, steps=args.steps, device=args.device)
    print(json.dumps(records, default=str))
    return records


if __name__ == "__main__":
    main()
