"""Qwen3 LLM inference example.

Counterpart of the JAX package's ``examples/llm_inference.py``: build a
Qwen3 model from an HF checkpoint directory (``--checkpoint DIR``: its
``config.json`` and safetensors, every weight required) or with random
weights (``--tiny``: 4 layers, 256 wide; else ``Qwen3Config()``'s 32
layers, 4096 wide), run the prompt through ``MojoGenerator.__call__``
(paged prefill and decode), print the tokens and the text. ``--perf`` runs
the ``PerfMojoGenerator`` sweep instead (prefill at 512, 1024 and 2048
tokens, decode at bs 1, 2, 4 and 8 at ctx 4000; ``--fused`` adds
``FusedDecode`` windows) and returns its records under ``perf``.
``--tokenizer DIR`` loads a Hugging Face tokenizer (``transformers``
needed for this flag only); without one the byte-level fallback encodes
the prompt.

Usage::

    python -m mojo_opset_tpu_torch.examples.llm_inference [--checkpoint DIR]
        [--tokenizer DIR] [--prompt TEXT] [--max-new-tokens N]
        [--block-size N] [--greedy] [--fused] [--perf] [--tiny] [--quant w8a8]
        [--quant-kv] [--speculative K] [--device cuda|cpu]
        [--debug-compare RULES] [--debug-dump RULES] [--profile-dir DIR]
        [--trace-out PATH]

Decode steps replay from CUDA graphs on the card (``--debug-*`` runs them
eagerly). ``main(argv)`` returns what it prints: the generated ids, the
decoded text, the session's allocator, and the tooling's records and files.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from mojo_opset_tpu_torch.examples._tools import (
    add_tool_flags,
    debugging,
    example_device,
    model_dtype,
    report,
    run_tools,
)
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM, quantize_qwen3
from mojo_opset_tpu_torch.runtime import (
    GeneratorHook,
    GreedySampler,
    MojoGenerator,
    PagedAttentionGenerationModel,
    PerfMojoGenerator,
    SpeculativeDecoder,
    TopKSampler,
)
from mojo_opset_tpu_torch.runtime.native import native_available
from mojo_opset_tpu_torch.utils.debugger import MojoDebugger
from mojo_opset_tpu_torch.utils.patching import apply_mojo_to_qwen3
from mojo_opset_tpu_torch.utils.profiler import create_cuda_profiler, profiler_activities

TINY = dict(hidden_size=256, intermediate_size=512, num_attention_heads=8, num_key_value_heads=4,
            num_hidden_layers=4, head_dim=32, vocab_size=32000, max_position_embeddings=4096)


def build_model(args) -> Qwen3ForCausalLM:
    """The ``--checkpoint`` weights in the checkpoint's dtype, or random
    weights from seed 0 drawn on ``args.device``; the int8 modes as the
    flags ask."""
    device = example_device(args)
    generator = torch.Generator(device=device).manual_seed(0)
    if args.checkpoint:
        model = apply_mojo_to_qwen3(args.checkpoint, device=device, generator=generator, strict=True)
        if args.quant_kv:  # the int8 KV cache rewires the attention; the parameters carry over one for one
            kv_model = Qwen3ForCausalLM(dataclasses.replace(model.qwen3_config, quant_kv=True), device=device)
            kv_model.load_state_dict(model.state_dict())
            model = kv_model
    else:
        shape = TINY if args.tiny else {}
        cfg = Qwen3Config(**shape, dtype=model_dtype(device), quant_kv=args.quant_kv)
        model = Qwen3ForCausalLM(cfg, device=device, generator=generator)
    if args.quant == "w8a8":
        model = quantize_qwen3(model)
    return model


class _FallbackTokenizer:
    """Byte-level stand-in when no tokenizer is available."""

    eos_token_id = 0

    def __call__(self, prompts, return_tensors=None):
        class R:
            input_ids = [[min(b, 255) + 1 for b in p.encode()] for p in (
                prompts if isinstance(prompts, list) else [prompts]
            )]

        return R()

    def decode(self, ids):
        return "".join(chr(max(int(i) - 1, 32) % 128) for i in np.asarray(ids).ravel())


def load_tokenizer(args):
    """``--tokenizer``'s Hugging Face tokenizer, else the byte-level fallback."""
    if args.tokenizer:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(args.tokenizer)
    return _FallbackTokenizer()


class _RunHook(GeneratorHook):
    """Notes the session's allocator (the run's spans come from the
    runtime's own, ``utils.tracing.span``, under ``--trace-out``)."""

    def __init__(self):
        self.allocator = None

    def after_prefill(self, *, logits, session):
        self.allocator = session.allocator


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", default=None, help="HF Qwen3 checkpoint directory (config.json, safetensors)")
    parser.add_argument("--tokenizer", default=None, help="HF tokenizer directory (needs transformers)")
    parser.add_argument("--prompt", default="The quick brown fox")
    parser.add_argument("--max-new-tokens", type=int, default=32)
    parser.add_argument("--block-size", type=int, default=64)
    parser.add_argument("--greedy", action="store_true")
    parser.add_argument("--fused", action="store_true", help="decode the whole window as one FusedDecode call")
    parser.add_argument("--perf", action="store_true", help="run the PerfMojoGenerator sweep")
    parser.add_argument("--tiny", action="store_true", help="small random model (no checkpoint)")
    parser.add_argument("--quant", default=None, choices=(None, "w8a8"),
                        help="post-training int8 weight+activation serving mode")
    parser.add_argument("--quant-kv", action="store_true",
                        help="int8 (C8) KV cache with prefill-calibrated channel scales")
    parser.add_argument("--speculative", type=int, default=0, metavar="K",
                        help="greedy speculative decoding with K drafts a round "
                             "(draft = the w8a8 twin of the model; lossless)")
    add_tool_flags(parser)
    return parser


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    model = build_model(args)
    tokenizer = load_tokenizer(args)
    if args.perf:
        gm = PagedAttentionGenerationModel(model, block_size=args.block_size)
        sampler = GreedySampler() if args.greedy else TopKSampler(top_k=50)
        gen = PerfMojoGenerator(gm, tokenizer, sampler, max_new_tokens=args.max_new_tokens)
        return {"perf": gen(prefill_seqlens=(512, 1024, 2048), decode_batch_sizes=(1, 2, 4, 8), fused=args.fused)}
    result = {}
    with run_tools(args, result, "llm_inference", profile_whole_run=False):
        t0 = time.perf_counter()
        if args.speculative:
            ids = np.asarray(tokenizer([args.prompt]).input_ids[0], np.int32)
            lens = np.array([ids.size], np.int32)
            spec = SpeculativeDecoder(model, quantize_qwen3(model), k=args.speculative, mode="greedy",
                                      block_size=args.block_size,
                                      device_graph=False if debugging(args) else None)
            out = spec.generate(ids, lens, max_new_tokens=args.max_new_tokens)
            result["rounds"] = spec.last_rounds
            result["allocator"] = "native" if native_available() else "numpy"
        else:
            gm = PagedAttentionGenerationModel(model, block_size=args.block_size,
                                               device_graph=False if debugging(args) else None)
            sampler = GreedySampler() if args.greedy else TopKSampler(top_k=50)
            run = _RunHook()
            hooks = [run]
            if args.profile_dir:
                hooks.append(create_cuda_profiler(args.profile_dir, wait=0, active=args.max_new_tokens,
                                                  activities=profiler_activities(args.device)))
            gen = MojoGenerator(gm, tokenizer, sampler, max_new_tokens=args.max_new_tokens, hooks=hooks)
            if MojoDebugger.enabled():  # by the flags, MOJO_DEBUG=1 or the caller: each forward counts from layer 0
                MojoDebugger.attach(gen)
            out = gen(args.prompt, fused_decode=args.fused)
            result["allocator"] = run.allocator
            if args.profile_dir:
                result["profile"] = hooks[1].traces
        result["seconds"] = time.perf_counter() - t0
    result["ids"] = np.asarray(out)
    result["decoded"] = tokenizer.decode(result["ids"][0])
    print("-" * 40)
    rounds = f" ({result['rounds']} verify rounds)" if args.speculative else ""
    print(f"generated ids{rounds}:", result["ids"])
    print("decoded:", result["decoded"])
    print(f"allocator: {result['allocator']}; {result['seconds']:.2f} s")
    report(result)
    return result


if __name__ == "__main__":
    main()
