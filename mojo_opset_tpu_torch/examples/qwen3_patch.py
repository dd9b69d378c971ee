"""Qwen3 HF-checkpoint patching example.

Counterpart of the JAX package's ``examples/qwen3_patch.py``: build the
port's Mojo-op Qwen3 straight from an HF checkpoint directory
(``utils.patching.apply_mojo_to_qwen3``, every weight required), generate
from the prompt and print the text; with ``--verify``, compare the
prompt's last-token logits against transformers' unpatched model on the
CPU (``transformers`` needed for this flag and for ``--tiny-selftest``).
The checkpoint's tokenizer is used where transformers can load it, else
the prompt's bytes stand in for token ids.

Usage::

    python -m mojo_opset_tpu_torch.examples.qwen3_patch --model-path DIR
        [--prompt TEXT] [--max-new-tokens N] [--top-k K] [--do-sample]
        [--verify] [--tiny-selftest] [--device cuda|cpu]

``--tiny-selftest`` saves a tiny random transformers Qwen3 to a temporary
directory and runs on it. ``main(argv)`` returns what it prints.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from mojo_opset_tpu_torch.examples._tools import example_device
from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel, TopKSampler
from mojo_opset_tpu_torch.utils.patching import apply_mojo_to_qwen3

VERIFY_MAX_ABS = 5e-2  # last-token logits against transformers' fp32 forward


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-path", default=None, help="local HF Qwen3 checkpoint directory")
    p.add_argument("--prompt", default="请用中文简要介绍 Qwen3 的主要能力。")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--top-k", type=int, default=50)
    p.add_argument("--do-sample", action="store_true", help="top-k sampling instead of greedy")
    p.add_argument("--verify", action="store_true", help="compare last-token logits against transformers")
    p.add_argument("--tiny-selftest", action="store_true", help="save a tiny random HF checkpoint and run on it")
    p.add_argument("--device", default="cuda", help="device of the model and its session (default: the card)")
    return p


def make_tiny_checkpoint() -> str:
    import transformers

    torch.manual_seed(0)
    cfg = transformers.Qwen3Config(
        hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
        head_dim=16, vocab_size=128, max_position_embeddings=128, tie_word_embeddings=False,
    )
    path = tempfile.mkdtemp(prefix="qwen3_tiny_")
    transformers.Qwen3ForCausalLM(cfg).save_pretrained(path, safe_serialization=True)
    return path


class _IdTokenizer:
    """Prints token ids, for a checkpoint without a tokenizer."""

    eos_token_id = 0

    def decode(self, ids):
        return " ".join(map(str, np.asarray(ids).ravel().tolist()))


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = example_device(args)
    path = args.model_path or (make_tiny_checkpoint() if args.tiny_selftest else None)
    if path is None:
        raise SystemExit("pass --model-path DIR or --tiny-selftest")

    model = apply_mojo_to_qwen3(path, device=device, strict=True)
    gm = PagedAttentionGenerationModel(model, block_size=16)
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(path, local_files_only=True)
        ids = np.asarray(tokenizer(args.prompt).input_ids, np.int32)
    except (ImportError, OSError, TypeError, ValueError):  # no transformers, or no tokenizer in the checkpoint
        tokenizer = _IdTokenizer()
        vocab = model.config.model_config.vocab_size
        ids = (np.frombuffer(args.prompt.encode(), np.uint8).astype(np.int32) % (vocab - 1)) + 1

    sampler = TopKSampler(args.top_k) if args.do_sample else GreedySampler()
    gen = MojoGenerator(gm, tokenizer, sampler, max_new_tokens=args.max_new_tokens)
    lens = np.array([ids.size], np.int32)
    out = gen.generate_from_ids(ids, lens, ignore_eos=False, silent=True)
    result = {"path": path, "ids": out, "decoded": tokenizer.decode(out[0])}
    print(result["decoded"])

    if args.verify:
        import transformers

        hf = transformers.AutoModelForCausalLM.from_pretrained(path, local_files_only=True,
                                                               torch_dtype=torch.float32).eval()
        with torch.no_grad():
            want = hf(input_ids=torch.tensor(ids[None], dtype=torch.long)).logits[0, -1]
        got, _ = gm(ids, context_input_len=lens)
        result["max_abs_err"] = float((got[0].float().cpu() - want.float()).abs().max())
        print(f"logits parity vs transformers: max abs err = {result['max_abs_err']:.2e}")
        if result["max_abs_err"] >= VERIFY_MAX_ABS:
            raise AssertionError(f"parity check failed: {result['max_abs_err']} >= {VERIFY_MAX_ABS}")
    return result


if __name__ == "__main__":
    main()
