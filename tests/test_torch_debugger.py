"""The port's precision debugger (``utils/debugger.py``) on the CPU.

The cases of the JAX package's tests/base/test_debug_utils.py on the
port's ops (its xla-tier ops become cuda-tier ones, whose kernel wrappers
run their plain versions on CPU tensors; its jit case becomes one under a
CUDA stream capture, monkeypatched), then parity with JAX's debugger on a
tiny fp32 Qwen3 (2 layers, 64 wide) whose port twin carries JAX's weights
through ``utils.weights.load_numpy_state``: over one prefill and one
decode step under ``*:*`` the port's compare records name the same
(op, layer, output) sequence as JAX's records of its Pallas tier (the
kernels the cuda tier ports), each within 1e-5; a perturbation injected
into one cuda-tier op is reported in ``log`` mode and taken out in
``replace`` mode.
"""

import logging
import re

import numpy as np
import pytest
import torch

import mojo_opset_tpu_torch as m
from mojo_opset_tpu_torch.backends.cuda.operators.normalization import CudaRMSNorm
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel
from mojo_opset_tpu_torch.utils import logging as logging_mod
from mojo_opset_tpu_torch.utils.debugger import MojoDebugger, _matches, _parse_rules
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

TINY = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
            head_dim=16, vocab_size=128, max_position_embeddings=64)
LENS = np.array([5, 3], np.int32)


@pytest.fixture(autouse=True)
def _clean_debugger():
    yield
    MojoDebugger.disable()


class _ListHandler(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture
def log_records():
    handler = _ListHandler()
    logger = logging.getLogger("mojo_opset_tpu_torch.utils.debugger")
    logger.addHandler(handler)
    yield handler.records
    logger.removeHandler(handler)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _cuda_groupgemm():
    w = torch.randn(2, 8, 8, generator=_gen(0))
    return m.MojoGroupGemm.get_backend_impl("cuda")(w)


def _gg_inputs(seed=1):
    return torch.randn(6, 8, generator=_gen(seed)), torch.tensor([2, 4], dtype=torch.int32)


def test_rule_parsing_and_matching():
    rules = _parse_rules("3:RMSNorm, *:PagedDecodeGQA, none:Gelu")
    assert _matches(rules, 3, "RMSNorm")
    assert not _matches(rules, 2, "RMSNorm")
    assert _matches(rules, 7, "PagedDecodeGQA")
    assert not _matches(rules, 0, "Gelu")
    assert not _matches(_parse_rules(""), 0, "RMSNorm")


def test_compare_logs_and_keeps_output(log_records):
    MojoDebugger.enable(compare="*:GroupGemm")
    out = _cuda_groupgemm()(*_gg_inputs())
    assert out.shape == (6, 8)
    assert any("cos_sim" in r.getMessage() for r in log_records)
    assert MojoDebugger.counts["compare"] == 1 and len(MojoDebugger.records) == 1


def test_replace_mode_substitutes_ref_output():
    MojoDebugger.enable(compare="*:GroupGemm", compare_mode="replace")
    op = _cuda_groupgemm()
    out = op(*_gg_inputs())
    want = MojoDebugger._shadow_of(op).forward(*_gg_inputs())
    assert type(MojoDebugger._shadow_of(op)).__name__ == "RefGroupGemm"
    assert torch.equal(out, want)


def test_dump_writes_npz(tmp_path):
    MojoDebugger.enable(dump="*:Silu", dump_dir=str(tmp_path))
    m.MojoSilu()(torch.randn(4, 4, generator=_gen(0)))
    files = list(tmp_path.rglob("*.npz"))
    assert len(files) == 1 and files[0].parent.name == "rank0"
    data = np.load(files[0])
    assert "in0" in data and "out0" in data
    assert MojoDebugger.counts["dump"] == 1


def test_env_rules_reread_each_forward(monkeypatch, tmp_path):
    MojoDebugger.enable(dump_dir=str(tmp_path))
    op = m.MojoSilu()
    op(torch.ones(2, 2))  # no rules -> nothing
    assert not list(tmp_path.rglob("*.npz"))
    monkeypatch.setenv("MOJO_DEBUG_DUMP", "*:Silu")
    op(torch.ones(2, 2))
    assert len(list(tmp_path.rglob("*.npz"))) == 1
    monkeypatch.delenv("MOJO_DEBUG_DUMP")
    op(torch.ones(2, 2))
    assert len(list(tmp_path.rglob("*.npz"))) == 1


def test_layer_occurrence_counting(tmp_path):
    MojoDebugger.enable(dump="1:Silu", dump_dir=str(tmp_path))
    op = m.MojoSilu()
    MojoDebugger.new_step()
    op(torch.ones(2))  # layer 0: no match
    op(torch.ones(2))  # layer 1: dump
    op(torch.ones(2))  # layer 2: no
    assert len(list(tmp_path.rglob("*.npz"))) == 1
    MojoDebugger.new_step()
    op(torch.ones(2))
    op(torch.ones(2))
    assert len(list(tmp_path.rglob("*.npz"))) == 2


def test_errors_are_swallowed():
    MojoDebugger.enable(compare="*:Silu")  # Silu has no cuda tier -> warns
    out = m.MojoSilu()(torch.ones(3))
    assert out.shape == (3,)


def test_debugger_skips_under_graph_capture(monkeypatch, tmp_path, log_records):
    """Under a CUDA stream capture the hook does no host work: nothing is
    counted or dumped, one warning, and the op runs as it would."""
    monkeypatch.setattr(logging_mod, "_WARNED", set())
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    MojoDebugger.enable(dump="*:Silu", compare="*:*", dump_dir=str(tmp_path / "dump"))
    op = m.MojoSilu()
    for _ in range(3):
        out = op(torch.ones(2, 2))
    assert float(out.sum()) > 0
    assert not (tmp_path / "dump").exists()
    assert not MojoDebugger._call_counts and not MojoDebugger.records
    assert sum("CUDA graph capture" in r.getMessage() for r in log_records) == 1


def _tiny_model(seed=3, **kw):
    return Qwen3ForCausalLM(Qwen3Config(**dict(TINY, **kw), dtype=torch.float32), device="cpu",
                            generator=_gen(seed))


class Tok:
    eos_token_id = 0


def test_attach_wires_step_resets_into_generator():
    """attach() resets occurrence counters before prefill and after each
    decode step, so `<layer>:<op>` rules address the same layer every
    forward."""
    model = _tiny_model(hidden_size=32, intermediate_size=64, num_attention_heads=2, head_dim=16)
    gen = MojoGenerator(PagedAttentionGenerationModel(model, block_size=16), Tok(), GreedySampler(), max_new_tokens=3)
    MojoDebugger.enable(compare="0:RMSNorm")
    MojoDebugger.attach(gen)
    gen.generate_from_ids(np.array([1, 2, 3], np.int32), np.array([3], np.int32), ignore_eos=True)
    # one prefill and two decode steps, each counting RMSNorm from layer 0
    assert [(r["op"], r["layer"]) for r in MojoDebugger.records] == [("RMSNorm", 0)] * 3


def test_compare_on_golden_tier_warns(monkeypatch, log_records):
    monkeypatch.setattr(logging_mod, "_WARNED", set())
    monkeypatch.setenv("MOJO_BACKEND", "ref")
    MojoDebugger.enable(compare="*:GroupGemm")
    op = m.MojoGroupGemm.get_backend_impl("ref")(torch.randn(2, 8, 8, generator=_gen(0)))
    op(*_gg_inputs())
    assert any("already the golden tier" in r.getMessage() for r in log_records)
    assert not MojoDebugger.records


def test_dump_and_compare_together(tmp_path, log_records):
    MojoDebugger.enable(compare="*:GroupGemm", dump="*:GroupGemm", dump_dir=str(tmp_path))
    _cuda_groupgemm()(*_gg_inputs())
    assert list(tmp_path.rglob("*.npz"))
    assert any("cos_sim" in r.getMessage() for r in log_records)
    assert MojoDebugger.counts == {"compare": 1, "dump": 1, "errors": 0}


def test_dump_skips_non_array_args_and_keeps_ints(tmp_path):
    MojoDebugger.enable(dump="*:GroupGemm", dump_dir=str(tmp_path))
    _cuda_groupgemm()(*_gg_inputs())
    data = np.load(list(tmp_path.rglob("*.npz"))[0])
    assert "in0" in data and "in1" in data  # the int32 group_list is dumped too
    assert data["in1"].dtype == np.int32


def test_internal_compare_failure_is_swallowed(monkeypatch):
    """A crash inside the debugger never breaks the model forward; it is
    counted, and the op's own output stands."""
    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(MojoDebugger, "_log_compare", classmethod(boom))
    MojoDebugger.enable(compare="*:GroupGemm")
    op = _cuda_groupgemm()
    out = op(*_gg_inputs())
    assert out.shape == (6, 8)
    assert torch.isfinite(out).all()
    assert torch.equal(out, op.forward(*_gg_inputs()))
    assert MojoDebugger.counts == {"compare": 0, "dump": 0, "errors": 1} and not MojoDebugger.records


def test_none_rule_excludes_op_within_wildcard(tmp_path):
    MojoDebugger.enable(dump="*:*, none:Silu", dump_dir=str(tmp_path))
    m.MojoSilu()(torch.ones(2, 2))
    assert not list(tmp_path.rglob("*.npz"))
    m.MojoGelu()(torch.ones(2, 2))
    assert len(list(tmp_path.rglob("*.npz"))) == 1


def test_disable_removes_hook(tmp_path):
    from torch.nn.modules.module import _global_forward_hooks

    MojoDebugger.enable(dump="*:Silu", dump_dir=str(tmp_path))
    assert MojoDebugger._on_forward in _global_forward_hooks.values()
    m.MojoSilu()(torch.ones(2))
    assert len(list(tmp_path.rglob("*.npz"))) == 1
    MojoDebugger.disable()
    assert not MojoDebugger.enabled() and MojoDebugger._on_forward not in _global_forward_hooks.values()
    m.MojoSilu()(torch.ones(2))
    assert len(list(tmp_path.rglob("*.npz"))) == 1


@pytest.mark.parametrize("mode", ["log", "replace"])
def test_the_ops_own_forward_hooks_still_run(tmp_path, mode):
    """The debugger acts between the op's forward and its own forward hooks
    (where a tensor-parallel op reduces its output), so those hooks see
    whatever the op returns, in either mode, for a dumped or compared op
    with or without a cuda tier."""
    ops = [_cuda_groupgemm(), m.MojoSilu()]
    inputs = [_gg_inputs(), (torch.ones(2, 2),)]
    want = [op(*x) + 1 for op, x in zip(ops, inputs)]
    for op in ops:
        op.register_forward_hook(lambda mod, args, out: out + 1)
    MojoDebugger.enable(compare="*:*", dump="*:*", dump_dir=str(tmp_path), compare_mode=mode)
    for op, x, expect in zip(ops, inputs, want):
        torch.testing.assert_close(op(*x), expect, atol=1e-6, rtol=1e-6)
    assert MojoDebugger.counts == {"compare": 1, "dump": 2, "errors": 0}


def test_tp2_model_under_the_debugger_serves_as_without_it(tmp_path):
    """Two gloo ranks serve a tp 2 Qwen3 (tests/torch_parallel_workers.py):
    with every op compared and every Gemm dumped, log mode leaves the
    prefill logits and the greedy tokens exactly as without the debugger
    and replace mode within fp32 rounding; each rank dumps under its own
    rank<N>/."""
    from tests.torch_parallel_workers import STEPS, spawn

    cfg = dict(hidden_size=64, intermediate_size=128, num_attention_heads=8, num_key_value_heads=4,
               num_hidden_layers=2, head_dim=16, vocab_size=256, max_position_embeddings=128)
    model = Qwen3ForCausalLM(Qwen3Config(**cfg, dtype=torch.float32), device="cpu", generator=_gen(11))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    lens = np.array([9, 4], np.int32)
    ids = np.random.default_rng(11).integers(1, 256, int(lens.sum())).astype(np.int32)
    ranks = spawn(tmp_path, 2, ["debugger_tp2"], dict(dense=dict(cfg=cfg, state=state, ids=ids, lens=lens)))
    for rank, result in enumerate(r["debugger_tp2"] for r in ranks):
        assert "error" not in result, result.get("error")
        logits, tokens = result["off"]
        assert tokens.shape == (2, STEPS)
        np.testing.assert_array_equal(result["log"][0], logits)
        np.testing.assert_array_equal(result["log"][1], tokens)
        np.testing.assert_allclose(result["replace"][0], logits, atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(result["replace"][1], tokens)
        for mode in ("log", "replace"):
            counts = result[f"{mode}_counts"]
            assert counts["compare"] > 0 and counts["dump"] > 0 and counts["errors"] == 0, counts
            assert result[f"{mode}_worst"] <= 1e-5
            dumps = list((tmp_path / f"dump_{mode}" / f"rank{rank}").glob("Gemm_L*.npz"))
            assert len(dumps) == counts["dump"]


# -- deeper dual-build cases ----------------------------------------------


class MojoDbgAffine(m.MojoOperator):
    """Test-only op: golden y = x * w."""

    def __init__(self, w):
        super().__init__()
        self.w = w

    def forward(self, x):
        return x * self.w


class CudaDbgAffine(MojoDbgAffine):
    """Deliberately-buggy accelerated tier: y = x * w + 0.5."""

    def forward(self, x):
        return x * self.w + 0.5


def test_compare_detects_injected_perturbation(log_records):
    """The dual-build compare sees a real tier bug."""
    MojoDebugger.enable(compare="*:DbgAffine")
    op = MojoDbgAffine.get_backend_impl("cuda")(torch.ones(4))
    op(torch.ones(4))
    msgs = [r.getMessage() for r in log_records if "debug compare" in r.getMessage()]
    assert msgs, "compare must log"
    assert "max_abs=5.000e-01" in msgs[-1]
    assert MojoDebugger.records[-1]["max_abs"] == 0.5


def test_compare_log_mode_keeps_buggy_output_replace_fixes_it():
    x = torch.ones(4)
    op = MojoDbgAffine.get_backend_impl("cuda")(torch.ones(4))
    MojoDebugger.enable(compare="*:DbgAffine", compare_mode="log")
    torch.testing.assert_close(op(x), torch.full((4,), 1.5))
    MojoDebugger.enable(compare="*:DbgAffine", compare_mode="replace")
    torch.testing.assert_close(op(x), torch.full((4,), 1.0))


def test_replace_mode_switchable_between_forwards():
    """Mode flips apply on the next forward without re-instantiating ops."""
    x = torch.ones(2)
    op = MojoDbgAffine.get_backend_impl("cuda")(torch.ones(2))
    MojoDebugger.enable(compare="*:DbgAffine", compare_mode="replace")
    torch.testing.assert_close(op(x), torch.full((2,), 1.0))
    MojoDebugger.compare_mode = "log"
    torch.testing.assert_close(op(x), torch.full((2,), 1.5))
    MojoDebugger.compare_mode = "replace"
    torch.testing.assert_close(op(x), torch.full((2,), 1.0))


def test_compare_does_not_alter_output_or_inputs():
    """log-mode compare only observes."""
    x, gl = _gg_inputs(3)
    op = _cuda_groupgemm()
    want = op(x, gl)
    x_before = x.clone()
    MojoDebugger.enable(compare="*:GroupGemm")
    got = op(x, gl)
    assert torch.equal(got, want)
    assert torch.equal(x, x_before)


def test_multiple_forwards_accumulate_steps_without_new_step():
    """Occurrence counters persist across forwards until new_step()."""
    MojoDebugger.enable(compare="*:DbgAffine")
    op = MojoDbgAffine.get_backend_impl("cuda")(torch.ones(2))
    op(torch.ones(2))
    op(torch.ones(2))
    assert MojoDebugger._call_counts.get("DbgAffine") == 2
    MojoDebugger.new_step()
    assert MojoDebugger._call_counts.get("DbgAffine") is None


def test_dump_multiple_ops_same_forward(tmp_path):
    """A wildcard dump rule captures several distinct ops in one forward."""
    MojoDebugger.enable(dump="*:Silu,*:Gelu", dump_dir=str(tmp_path))
    m.MojoSilu()(torch.ones(2, 2))
    m.MojoGelu()(torch.ones(2, 2))
    names = [f.name for f in tmp_path.rglob("*.npz")]
    assert any(n.startswith("Silu") for n in names)
    assert any(n.startswith("Gelu") for n in names)


def test_no_rules_no_counting_overhead():
    """With the debugger enabled but ruleless, the hook does no occurrence
    bookkeeping."""
    MojoDebugger.enable()
    MojoDebugger.new_step()
    m.MojoSilu()(torch.ones(2))
    assert not MojoDebugger._call_counts


def test_unmatched_rule_warns_but_runs():
    """Rules naming ops that never execute do not affect the ones that do."""
    MojoDebugger.enable(compare="*:NoSuchOp")
    out = m.MojoSilu()(torch.ones(3))
    assert out.shape == (3,)


def test_compare_through_model_forward():
    """Rule-driven compare fires inside a full eager model forward: the
    per-layer error-isolation workflow."""
    model = _tiny_model(0, hidden_size=32, intermediate_size=64, num_attention_heads=2, num_key_value_heads=1)
    gm = PagedAttentionGenerationModel(model, block_size=16)
    MojoDebugger.enable(compare="*:RMSNorm")
    MojoDebugger.new_step()
    gm(np.arange(8, dtype=np.int32), context_input_len=np.array([8], np.int32))
    # four norms a layer (input, q, k, post-attention) and the final one
    assert [r["layer"] for r in MojoDebugger.records] == list(range(4 * 2 + 1))
    assert {r["op"] for r in MojoDebugger.records} == {"RMSNorm"}


# -- parity with JAX's debugger ---------------------------------------------

_JAX_COMPARE = re.compile(r"\[debug compare\] (\w+) layer (\d+) out(\d+): max_abs=")


@pytest.fixture(scope="module")
def jax_pair():
    """JAX's records over a prefill and a decode step of a tiny fp32 Qwen3
    on its Pallas tier (interpret mode on the CPU), and the port model with
    JAX's weights."""
    import os

    import jax
    import jax.numpy as jnp

    import mojo_opset_tpu as jm
    from mojo_opset_tpu.modeling.qwen3 import Qwen3Config as JaxQwen3Config
    from mojo_opset_tpu.modeling.qwen3 import Qwen3ForCausalLM as JaxQwen3
    from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
    from mojo_opset_tpu.utils.debugger import MojoDebugger as JaxDebugger
    from mojo_opset_tpu.utils.hf import state_dict_of

    before = os.environ.get("MOJO_BACKEND")
    os.environ["MOJO_BACKEND"] = "pallas"
    try:
        jax_model = JaxQwen3(JaxQwen3Config(**TINY, dtype=jnp.float32), key=jax.random.PRNGKey(7))
    finally:
        if before is None:
            os.environ.pop("MOJO_BACKEND")
        else:
            os.environ["MOJO_BACKEND"] = before
    handler = _ListHandler()
    jax_logger = logging.getLogger("mojo_opset_tpu.utils.debugger")
    jax_logger.addHandler(handler)
    try:
        JaxDebugger.enable(compare="*:*")
        gm = JaxPaged(jax_model, block_size=16, jit=False)
        JaxDebugger.new_step()
        logits, session = gm(_prompt(), context_input_len=LENS)
        JaxDebugger.new_step()
        gm(np.asarray(jnp.argmax(logits, -1), np.int32), session=session)
    finally:
        JaxDebugger.disable()
        jax_logger.removeHandler(handler)
    records = [_JAX_COMPARE.search(r.getMessage()) for r in handler.records]
    records = [(g[1], int(g[2]), int(g[3])) for g in records if g]

    def pallas_tier(name):  # the ops whose Pallas kernel the port's cuda tier ports
        return getattr(jm, f"Mojo{name}").get_registry().get("pallas").__name__.startswith("Pallas")

    kept = [r for r in records if pallas_tier(r[0])]
    port = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32), device="cpu")
    load_numpy_state(port, state_dict_of(jax_model))
    return records, kept, port, np.asarray(logits)


def _prompt():
    return np.random.default_rng(0).integers(1, TINY["vocab_size"], int(LENS.sum())).astype(np.int32)


def _prefill_and_decode(model):
    """Logits of a prefill and of one decode step on its argmax."""
    gm = PagedAttentionGenerationModel(model, block_size=16)
    MojoDebugger.new_step()
    logits, session = gm(_prompt(), context_input_len=LENS)
    MojoDebugger.new_step()
    step, _ = gm(torch.argmax(logits, -1).to(torch.int32), session=session)
    return logits, step


def test_record_sequence_equals_jax(jax_pair):
    jax_records, jax_kernel_records, port, jax_logits = jax_pair
    MojoDebugger.enable(compare="*:*")
    logits, _ = _prefill_and_decode(port)
    got = [(r["op"], r["layer"], r["out"]) for r in MojoDebugger.records]
    # JAX's xla-tier store (no Pallas kernel) is the one op its records add
    assert {r[0] for r in jax_records} - {r[0] for r in jax_kernel_records} == {"StorePagedKVCache"}
    assert got == jax_kernel_records
    assert len(got) == 2 * (2 * 4 + 1 + 2 * 2 + 2)  # per forward: 9 norms, 2 RoPEs (q, k), 2 attentions
    assert max(r["max_abs"] for r in MojoDebugger.records) <= 1e-5
    assert MojoDebugger.counts == {"compare": len(got), "dump": 0, "errors": 0}
    np.testing.assert_allclose(logits.numpy(), jax_logits, atol=1e-4, rtol=1e-4)


def test_injected_perturbation_is_reported_and_replaced(jax_pair, monkeypatch):
    _, _, port, _ = jax_pair
    monkeypatch.setenv("MOJO_BACKEND", "ref")
    golden = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32), device="cpu")
    golden.load_state_dict(port.state_dict())
    monkeypatch.delenv("MOJO_BACKEND")
    want = _prefill_and_decode(golden)
    plain_forward = CudaRMSNorm.forward
    monkeypatch.setattr(CudaRMSNorm, "forward", lambda self, x: plain_forward(self, x) + 0.25)
    perturbed = _prefill_and_decode(port)
    assert (perturbed[0] - want[0]).abs().max() > 1e-2  # the perturbation reaches the logits

    MojoDebugger.enable(compare="*:RMSNorm", compare_mode="log")
    logged = _prefill_and_decode(port)
    for got, was in zip(logged, perturbed):
        torch.testing.assert_close(got, was, atol=0, rtol=0)  # log mode only observes
    assert len(MojoDebugger.records) == 2 * 9
    assert all(abs(r["max_abs"] - 0.25) < 1e-5 for r in MojoDebugger.records)

    MojoDebugger.enable(compare="*:*", compare_mode="replace")
    replaced = _prefill_and_decode(port)
    for got, ref in zip(replaced, want):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
