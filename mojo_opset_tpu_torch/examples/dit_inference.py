"""Wan2.2 DiT denoising-loop example.

Counterpart of the JAX package's ``examples/dit_inference.py``: Euler
sampling of random latents with the Wan DiT backbone (random weights, or
with ``--ckpt-dir DIR`` a Wan2.2 DiT checkpoint in safetensors under the
official module names, every weight required, into the model the flags
describe; a random text context), then, with ``--decode-vae``, a small
causal video VAE's decode of the result.

Usage::

    python -m mojo_opset_tpu_torch.examples.dit_inference [--steps 10]
        [--frames 2] [--size 64] [--dim 512] [--layers 8] [--decode-vae]
        [--ckpt-dir DIR] [--device cuda|cpu] [--debug-compare RULES]
        [--debug-dump RULES] [--profile-dir DIR] [--trace-out PATH]

``main(argv)`` returns what it prints: the denoised latent with its mean
and std, the decoded video's shape, the seconds elapsed after each step,
and the tooling's outcome.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch

from mojo_opset_tpu_torch.examples._tools import add_tool_flags, example_device, model_dtype, report, run_tools
from mojo_opset_tpu_torch.modeling.wan2_2 import WanConfig, WanModel, WanVAE_
from mojo_opset_tpu_torch.utils.hf import load_sharded_safetensors
from mojo_opset_tpu_torch.utils.patching import apply_mojo_to_wan2_2


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--frames", type=int, default=2)
    parser.add_argument("--size", type=int, default=64, help="latent H=W")
    parser.add_argument("--dim", type=int, default=512)
    parser.add_argument("--layers", type=int, default=8)
    parser.add_argument("--decode-vae", action="store_true")
    parser.add_argument("--ckpt-dir", default=None, help="Wan2.2 DiT checkpoint dir (safetensors, official names)")
    add_tool_flags(parser)
    return parser


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = example_device(args)
    cfg = WanConfig(
        patch_size=(1, 2, 2), text_len=64, in_dim=16, dim=args.dim,
        ffn_dim=args.dim * 4, freq_dim=256, text_dim=512, out_dim=16,
        num_heads=args.dim // 64, num_layers=args.layers, dtype=model_dtype(device),
    )
    generator = torch.Generator(device=device).manual_seed(0)
    if args.ckpt_dir:
        model = apply_mojo_to_wan2_2(load_sharded_safetensors(args.ckpt_dir), config=cfg, device=device,
                                     generator=generator, strict=True)
    else:
        model = WanModel(cfg, device=device, generator=generator)

    F, H, W = args.frames, args.size // 8, args.size // 8
    seq_len = F * (H // 2) * (W // 2)
    inputs = torch.Generator(device=device).manual_seed(42)
    latents = torch.randn((16, F, H, W), device=device, generator=inputs)
    context = [torch.randn((32, 512), device=device, generator=inputs)]
    sigmas = torch.linspace(1.0, 0.0, args.steps + 1).tolist()  # a simple Euler schedule

    result = {"elapsed_seconds": []}
    x = latents
    with run_tools(args, result, "dit_inference") as tracer, torch.inference_mode():
        t0 = time.perf_counter()
        for i in range(args.steps):
            with tracer.span("step", step=i) if tracer else contextlib.nullcontext():
                t = torch.tensor([1000 * sigmas[i]], device=device)
                velocity = model([x], t, context, seq_len=seq_len)[0].float()
                x = x + velocity * (sigmas[i + 1] - sigmas[i])
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            result["elapsed_seconds"].append(time.perf_counter() - t0)
            print(f"step {i + 1}/{args.steps} sigma={sigmas[i]:.3f} ({result['elapsed_seconds'][-1]:.2f}s elapsed)")
        result["latent"] = x
        result["mean"], result["std"] = float(x.mean()), float(x.std())
        print("denoised latent:", tuple(x.shape), "mean", result["mean"], "std", result["std"])

        if args.decode_vae:
            vae = WanVAE_(dim=32, dec_dim=32, z_dim=16, dim_mult=(2, 2), num_res_blocks=1,
                          temperal_downsample=(True,), device=device,
                          generator=torch.Generator(device=device).manual_seed(2))
            with tracer.span("vae_decode") if tracer else contextlib.nullcontext():
                result["video"] = vae.decode(x[None])
            print("decoded video:", tuple(result["video"].shape))
    report(result)
    return result


if __name__ == "__main__":
    main()
