"""Continuous-batching serving demo.

Counterpart of the JAX package's ``examples/continuous_serving.py``: feeds a
synthetic request stream through ``ContinuousBatchingGenerator``
(optionally with speculative rounds, the draft being the model's w8a8
twin) on a small random Qwen3 (4 layers, 256 wide) and reports each
request's tokens and the aggregate throughput.

Usage::

    python -m mojo_opset_tpu_torch.examples.continuous_serving [--requests 8]
        [--slots 4] [--max-new-tokens 16] [--decode-window 1] [--bucket-admits]
        [--max-prefill-chunk N] [--prefix-cache-blocks N] [--speculative K]
        [--block-size 32] [--device cuda|cpu] [--debug-compare RULES]
        [--debug-dump RULES] [--profile-dir DIR] [--trace-out PATH]

``main(argv)`` returns what it prints: each request's tokens, the token
count, the seconds and the tokens a second, and the tooling's outcome.
"""

from __future__ import annotations

import argparse
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
from mojo_opset_tpu_torch.examples.llm_inference import TINY
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM, quantize_qwen3
from mojo_opset_tpu_torch.runtime import ContinuousBatchingGenerator, SpeculativeContinuousBatchingGenerator


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--decode-window", type=int, default=1)
    p.add_argument("--bucket-admits", action="store_true")
    p.add_argument("--max-prefill-chunk", type=int, default=None)
    p.add_argument("--prefix-cache-blocks", type=int, default=0)
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="speculative rounds with the w8a8 self-draft")
    p.add_argument("--block-size", type=int, default=32)
    add_tool_flags(p)
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = example_device(args)
    cfg = Qwen3Config(**TINY, dtype=model_dtype(device))
    model = Qwen3ForCausalLM(cfg, device=device, generator=torch.Generator(device=device).manual_seed(0))
    graphs = False if debugging(args) else None
    if args.speculative:
        gen = SpeculativeContinuousBatchingGenerator(
            model, quantize_qwen3(model), speculative_k=args.speculative,
            batch_slots=args.slots, block_size=args.block_size,
            max_new_tokens=args.max_new_tokens, device_graph=graphs,
        )
    else:
        gen = ContinuousBatchingGenerator(
            model, batch_slots=args.slots, block_size=args.block_size,
            max_new_tokens=args.max_new_tokens,
            decode_window=args.decode_window, bucket_admits=args.bucket_admits,
            max_prefill_chunk=args.max_prefill_chunk,
            prefix_cache_blocks=args.prefix_cache_blocks, device_graph=graphs,
        )

    rng = np.random.default_rng(0)
    rids = [
        gen.submit(rng.integers(1, cfg.vocab_size, (int(n),)).astype(np.int32))
        for n in rng.integers(4, 48, (args.requests,))
    ]
    result = {}
    with run_tools(args, result, "continuous_serving") as tracer:
        t0 = time.perf_counter()
        results = gen.run()
        result["seconds"] = time.perf_counter() - t0
        if tracer:
            for rid in rids:
                tracer.instant("request_done", rid=rid, tokens=len(results[rid]))
    result["requests"] = {rid: np.asarray(results[rid]) for rid in rids}
    result["tokens"] = sum(len(v) for v in result["requests"].values())
    result["tokens_per_s"] = result["tokens"] / result["seconds"]
    for rid in rids:
        print(f"req {rid}: {result['requests'][rid].tolist()}")
    print("-" * 40)
    print(f"{len(rids)} requests, {result['tokens']} tokens in {result['seconds']:.2f}s "
          f"({result['tokens_per_s']:.1f} tok/s aggregate)")
    report(result)
    return result


if __name__ == "__main__":
    main()
