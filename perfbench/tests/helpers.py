"""Helpers of the benchmark's CPU tests: a tiny cell's data files in a directory of their own."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            num_hidden_layers=2, vocab_size=256, torch_dtype="float32", initializer_range=0.2)
TINY_MOE = dict(TINY, num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32)


def write_tiny_root(root: Path, moe: bool = False, batch: int = 3, trace=None, limits=None,
                    dist: str = "uniform") -> Path:
    """A checkout's data files only, in ``root``: a BENCHMARK.json with one cell
    ``tiny.cell`` of a tiny Qwen3 (or Qwen3-MoE) in float32 under a tiny mix, and its limits."""
    base = json.loads((ROOT / "perfbench" / "configs" / ("qwen3-30b-a3b.json" if moe else "qwen3-4b.json")).read_text())
    base.update(TINY_MOE if moe else TINY)
    base["deployment"] = dict(base["deployment"], block_size=4)
    mix = {"driver": "static_batch", "loop": "closed", "clients": 1, "batch": batch,
           "prompt_len": {"dist": dist, "min": 5, "max": 12}, "output_len": {"dist": "uniform", "min": 3, "max": 6},
           "check": {"requests": batch, "rows_per_call": batch, "logit_steps": 6},
           "trace": trace or [{"span": "prefill", "calls": [0, 1], "from": 0, "to": 1},
                              {"span": "decode", "calls": [0, 1], "from": 1, "to": 4}]}
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"] = [{"name": "tiny", "source": "tiny Qwen3 for tests", "file": "perfbench/configs/tiny.json",
                            "reduced": [], "why": "tiny"}]
    manifest["workloads"] = [{"name": "tiny.cell", "config": "tiny", "traffic": "tiny-mix", "chips": 1,
                              "why": "tiny"}]
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = ["tiny.cell"]
    files = {"BENCHMARK.json": manifest, "perfbench/configs/tiny.json": base,
             "perfbench/traffic/tiny-mix.json": mix,
             "perfbench/limits/tiny.cell.json": limits or {"gap": 1e-3, "logit_err": 1e-3}}
    for name, data in files.items():
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(data))
    return root
