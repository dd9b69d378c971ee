"""The port's chrome-trace emitter (``utils/tracing.py``) and profiler
hook (``utils/profiler.py``) on the CPU: the four cases of the JAX
package's tests/base/test_tracing_profiler.py, the round trip also event
for event against JAX's emitter (names and phases), the profiler hook on
CPU activities inside a ``MojoGenerator``, and ``PerfHook``.
"""

import json
import time

import numpy as np
import torch

from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel, PerfHook
from mojo_opset_tpu_torch.utils.profiler import CUDAProfilerHook, create_cuda_profiler, trace_annotation
from mojo_opset_tpu_torch.utils.tracing import MojoTracingGenerator


def _emit(tr):
    tr.set_thread_name("decode")
    tr.begin("prefill", model="qwen3")
    tr.end("prefill")
    tr.instant("eos")
    tr.complete("kernel", start_us=10.0, dur_us=5.0, flops=123)
    with tr.span("step"):
        pass


def _events(path):
    data = json.loads(path.read_text())
    return data["traceEvents"] if isinstance(data, dict) else data


def test_chrome_trace_round_trip(tmp_path):
    from mojo_opset_tpu.utils.tracing import MojoTracingGenerator as JaxTracingGenerator

    tr = MojoTracingGenerator(process_name="unit")
    _emit(tr)
    out = tmp_path / "trace.json"
    assert tr.save(str(out)) == str(out)
    events = _events(out)
    phases = [e.get("ph") for e in events]
    names = [e.get("name") for e in events]
    # metadata + B/E pair + instant + complete + span pair
    assert "prefill" in names and "kernel" in names and "step" in names
    assert "B" in phases and "E" in phases and "X" in phases and "i" in phases
    assert any(e.get("ph") == "M" for e in events)  # process/thread metadata (chrome://tracing needs it)
    b = next(e for e in events if e.get("name") == "prefill" and e["ph"] == "B")
    e_ = next(e for e in events if e.get("name") == "prefill" and e["ph"] == "E")
    assert e_["ts"] >= b["ts"]
    assert b["args"]["model"] == "qwen3"
    # event for event, JAX's emitter writes the same names, phases and keys
    jax_tr = JaxTracingGenerator(process_name="unit")
    _emit(jax_tr)
    jax_out = tmp_path / "jax_trace.json"
    jax_tr.save(str(jax_out))
    jax_events = _events(jax_out)
    assert [(e["name"], e["ph"], sorted(e)) for e in events] == [(e["name"], e["ph"], sorted(e)) for e in jax_events]
    assert [e.get("args") for e in events] == [e.get("args") for e in jax_events]


def test_span_records_duration(tmp_path):
    tr = MojoTracingGenerator()
    with tr.span("sleepy"):
        time.sleep(0.01)
    out = tmp_path / "t.json"
    tr.save(str(out))
    events = _events(out)
    b = next(e for e in events if e.get("name") == "sleepy" and e["ph"] == "B")
    e_ = next(e for e in events if e.get("name") == "sleepy" and e["ph"] == "E")
    assert e_["ts"] - b["ts"] >= 9_000  # >= 9 ms in µs


def _tiny_generator(max_new_tokens):
    cfg = Qwen3Config(hidden_size=32, intermediate_size=64, num_attention_heads=2, num_key_value_heads=2,
                      num_hidden_layers=1, head_dim=16, vocab_size=64, max_position_embeddings=64,
                      dtype=torch.float32)
    model = Qwen3ForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))

    class Tok:
        eos_token_id = 0

    return MojoGenerator(PagedAttentionGenerationModel(model, block_size=16), Tok(), GreedySampler(),
                         max_new_tokens=max_new_tokens)


def test_profiler_hook_wires_into_generator(tmp_path):
    """CUDAProfilerHook runs through a real generate loop on CPU
    activities: the trace starts after ``wait`` decode steps, stops after
    ``active`` more, and is exported as a chrome trace; generation is
    unchanged."""
    gen = _tiny_generator(6)
    ids, lens = np.array([1, 2, 3], np.int32), np.array([3], np.int32)
    want = gen.generate_from_ids(ids, lens, ignore_eos=True)
    hook = CUDAProfilerHook(log_dir=str(tmp_path / "window"), wait=1, active=2)
    assert hook.activities == [torch.profiler.ProfilerActivity.CPU]
    gen._hooks.append(hook)
    with trace_annotation("generate"):
        out = gen.generate_from_ids(ids, lens, ignore_eos=True)
    np.testing.assert_array_equal(out, want)
    assert out.shape == (1, 6)
    assert hook.traces == [str(tmp_path / "window" / "trace.json")] and not hook._running
    names = {e.get("name") for e in _events(tmp_path / "window" / "trace.json")}
    assert any(n and n.startswith("aten::") for n in names)
    # wait=0 covers the prefill too (a whole run's trace, as the examples take it)
    whole = create_cuda_profiler(str(tmp_path / "whole"), wait=0, active=10)
    gen._hooks[-1] = whole
    gen.generate_from_ids(ids, lens, ignore_eos=True)
    assert whole.traces == [str(tmp_path / "whole" / "trace.json")]
    assert len(_events(tmp_path / "whole" / "trace.json")) > len(_events(tmp_path / "window" / "trace.json"))


def test_perf_hook_records_prefill_and_decode():
    gen = _tiny_generator(5)
    hook = PerfHook()
    gen._hooks.append(hook)
    gen.generate_from_ids(np.array([1, 2, 3, 4], np.int32), np.array([4], np.int32), ignore_eos=True)
    assert hook.records, "PerfHook recorded nothing"
    rec = hook.records[-1]
    assert rec["batch_size"] == 1 and rec["in_tok"] == 4
    assert rec["prefill_ms"] > 0 and rec["decode_avg_ms"] > 0
