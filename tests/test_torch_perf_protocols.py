"""The port's end-to-end perf protocols on the CPU against the JAX
package's: ``PerfMojoGenerator`` (JAX tests/base/test_perf_generator.py's
three cases, and the records' ``in_tok``, ``batch_size`` and
``decode_steps`` equal to JAX's for the same arguments), ``DumpHook`` (each
``.npy`` of a tiny Qwen3 with JAX's weights against JAX's), the DiT
protocol (JAX tests/models/test_dit_protocol.py's cases; token counts and
the FLOPs model equal to JAX's), ``run_dit_perf`` and its CLI, and
``llm_inference --perf``.

Tolerances, and why: record fields that count (tokens, batch sizes,
steps, FLOPs) are compared exactly; dumped logits hold to the fp32 ladder
(``utils/acc.py``: atol 6e-3, rtol 1e-4), the port's paged attention and
JAX's summing in other orders. Times are the host clock's on the CPU and
are only checked to be positive.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.benchmark import dit_protocol as jax_dit
from mojo_opset_tpu.modeling.qwen3 import Qwen3Config as JaxQwen3Config
from mojo_opset_tpu.modeling.qwen3 import Qwen3ForCausalLM as JaxQwen3
from mojo_opset_tpu.modeling.wan2_2 import WanConfig as JaxWanConfig
from mojo_opset_tpu.modeling.wan2_2 import WanModel as JaxWanModel
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.runtime.generation import DumpHook as JaxDumpHook
from mojo_opset_tpu.runtime.generation import GreedySampler as JaxGreedy
from mojo_opset_tpu.runtime.generation import MojoGenerator as JaxGenerator
from mojo_opset_tpu.runtime.generation import PerfMojoGenerator as JaxPerfGenerator
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.benchmark import dit_protocol
from mojo_opset_tpu_torch.benchmark.dit_protocol import PerfDiTRunner, dit_step_flops, run_dit_perf
from mojo_opset_tpu_torch.examples import llm_inference
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
from mojo_opset_tpu_torch.modeling.wan2_2 import WanConfig, WanModel
from mojo_opset_tpu_torch.runtime import (
    DumpHook,
    GreedySampler,
    MojoGenerator,
    PagedAttentionGenerationModel,
    PerfMojoGenerator,
)
from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

TINY = dict(hidden_size=32, intermediate_size=64, num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
            head_dim=8, vocab_size=64, max_position_embeddings=256)
SWEEP = dict(prefill_seqlens=(16, 32), decode_batch_sizes=(1, 2))
TINY_DIT = dict(patch_size=(1, 2, 2), text_len=16, in_dim=4, dim=64, ffn_dim=128, freq_dim=32, text_dim=48, out_dim=4,
                num_heads=2, num_layers=2)


class _Tok:
    eos_token_id = 0


@pytest.fixture(scope="module")
def models():
    """(JAX tiny Qwen3, the port's with its weights)."""
    jax_model = JaxQwen3(JaxQwen3Config(**TINY, dtype=jnp.float32), key=jax.random.PRNGKey(0))
    port = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32), device="cpu")
    load_numpy_state(port, state_dict_of(jax_model))
    return jax_model, port


def _perf_gen(port, max_new_tokens=4):
    gen = PerfMojoGenerator(PagedAttentionGenerationModel(port, block_size=16), _Tok(), GreedySampler(),
                            max_new_tokens=max_new_tokens)
    gen.DECODE_CONTEXT = 24  # the protocol's fixed context, shrunk for the CPU
    return gen


@pytest.fixture(scope="module")
def jax_sweep(models):
    gen = JaxPerfGenerator(JaxPaged(models[0], block_size=16), _Tok(), JaxGreedy(), max_new_tokens=4)
    gen.DECODE_CONTEXT = 24
    return gen(**SWEEP, fused=True)


def _counts(records, keys):
    return [{k: r[k] for k in keys} for r in records]


def test_protocol_sweep_records(models, jax_sweep):
    out = _perf_gen(models[1])(**SWEEP)
    assert [r["in_tok"] for r in out["prefill"]] == [16, 32]
    for r in out["prefill"]:
        assert r["batch_size"] == 1 and r["prefill_ms"] > 0
    assert [r["batch_size"] for r in out["decode"]] == [1, 2]
    for r in out["decode"]:
        assert r["decode_steps"] == 3  # max_new_tokens - 1 stepwise decodes
        assert r["decode_avg_ms"] > 0 and r["throughput"] > 0
    assert out["fused_decode"] == []
    keys = ("in_tok", "batch_size", "decode_steps")
    assert _counts(out["prefill"], keys) == _counts(jax_sweep["prefill"], keys)
    assert _counts(out["decode"], keys) == _counts(jax_sweep["decode"], keys)


def test_warm_run_excluded_from_records(models):
    """Each case runs twice; only the second (warm) run is recorded."""
    out = _perf_gen(models[1])(prefill_seqlens=(16,), decode_batch_sizes=(1,))
    assert len(out["prefill"]) == 1
    assert len(out["decode"]) == 1


def test_fused_decode_sweep(models, jax_sweep):
    out = _perf_gen(models[1])(**SWEEP, fused=True)
    keys = ("batch_size", "decode_steps")
    assert _counts(out["fused_decode"], keys) == _counts(jax_sweep["fused_decode"], keys)
    r = out["fused_decode"][0]
    assert r["batch_size"] == 1 and r["decode_steps"] == 4
    assert r["throughput"] > 0 and r["timer"] == "host"


def test_dump_hook_matches_jax(models, tmp_path):
    jax_model, port = models
    ids = np.random.default_rng(0).integers(1, TINY["vocab_size"], 12).astype(np.int32)
    lens = np.array([7, 5], np.int32)
    jax_gen = JaxGenerator(JaxPaged(jax_model, block_size=16), _Tok(), JaxGreedy(), max_new_tokens=5,
                           hooks=[JaxDumpHook(str(tmp_path / "jax"), max_decode_steps=3)])
    want_ids = jax_gen.generate_from_ids(ids, lens, ignore_eos=True, silent=True)
    gen = MojoGenerator(PagedAttentionGenerationModel(port, block_size=16), _Tok(), GreedySampler(), max_new_tokens=5,
                        hooks=[DumpHook(str(tmp_path / "port"), max_decode_steps=3)])
    np.testing.assert_array_equal(gen.generate_from_ids(ids, lens, ignore_eos=True, silent=True), want_ids)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["decode_step_001_logits.npy", "decode_step_002_logits.npy", "decode_step_003_logits.npy",
                     "prefill_logits.npy"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert got.dtype == np.float32 and got.shape == want.shape == (2, TINY["vocab_size"])
        check_tol_diff(got, want, **tols_for(torch.float32))


def test_dump_hook_saves_bf16_as_fp32(tmp_path):
    hook = DumpHook(str(tmp_path), max_decode_steps=1)
    logits = torch.tensor([[1.5, -2.25]], dtype=torch.bfloat16)
    hook.after_prefill(logits=logits, session=None)
    hook.after_decode_step(step=1, logits=logits, next_token_id=None)
    hook.after_decode_step(step=2, logits=logits, next_token_id=None)  # past max_decode_steps
    assert sorted(p.name for p in tmp_path.iterdir()) == ["decode_step_001_logits.npy", "prefill_logits.npy"]
    saved = np.load(tmp_path / "prefill_logits.npy")
    assert saved.dtype == np.float32 and saved.tolist() == [[1.5, -2.25]]


def test_llm_inference_perf(monkeypatch):
    monkeypatch.setattr(PerfMojoGenerator, "DECODE_CONTEXT", 24)
    out = llm_inference.main(["--perf", "--tiny", "--device", "cpu", "--greedy", "--max-new-tokens", "3", "--fused"])
    perf = out["perf"]
    assert [r["in_tok"] for r in perf["prefill"]] == [512, 1024, 2048]
    assert [r["batch_size"] for r in perf["decode"]] == [1, 2, 4, 8]
    assert [r["batch_size"] for r in perf["fused_decode"]] == [1, 2, 4, 8]
    assert all(r["decode_steps"] == 2 for r in perf["decode"])


# -- the DiT protocol -------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dit():
    return WanModel(WanConfig(**TINY_DIT), device="cpu", generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def jax_runner():
    return jax_dit.PerfDiTRunner(JaxWanModel(JaxWanConfig(**TINY_DIT), key=jax.random.PRNGKey(0)), text_tokens=8)


def test_dit_protocol_records(tiny_dit, jax_runner):
    sizes = ((1, 8, 8), (2, 8, 8))
    records = PerfDiTRunner(tiny_dit, text_tokens=8).run(sizes=sizes, steps=2)
    assert len(records) == 2
    for r, size in zip(records, sizes):
        assert r["latent"] == size
        assert r["denoise_ms"] > 0 and r["tflops"] > 0 and r["timer"] == "host"
        assert r["tokens"] == jax_runner._case_inputs(size)[2]
    assert [r["tokens"] for r in records] == [1 * 4 * 4, 2 * 4 * 4]  # the patchify grid


def test_dit_flops_model_scales(tiny_dit):
    cfg = tiny_dit.cfg
    f1 = dit_step_flops(cfg, seq_len=64, text_len=8)
    f2 = dit_step_flops(cfg, seq_len=128, text_len=8)
    assert f2 > f1 * 2  # the quadratic self-attention term
    ffn_only = 2.0 * cfg.num_layers * 2 * 64 * cfg.dim * cfg.ffn_dim
    assert f1 > ffn_only
    jax_cfg = JaxWanConfig(**TINY_DIT)
    for seq_len, text_len in ((64, 8), (128, 8), (4400, 512)):
        assert dit_step_flops(cfg, seq_len, text_len) == jax_dit.dit_step_flops(jax_cfg, seq_len, text_len)


def test_dit_denoise_step_moves_latent(tiny_dit):
    runner = PerfDiTRunner(tiny_dit, text_tokens=8)
    x, ctx, seq_len = runner._case_inputs((1, 8, 8))
    with torch.inference_mode():
        v = tiny_dit([x], torch.ones(1), [ctx], seq_len=seq_len)[0]
    assert v.shape == (tiny_dit.cfg.out_dim, 1, 8, 8)
    assert float(v.abs().max()) > 0


def test_run_dit_perf_and_cli():
    records = run_dit_perf(dim=64, layers=1, sizes=((1, 8, 8),), steps=2, device="cpu")
    assert [r["tokens"] for r in records] == [16] and records[0]["denoise_ms"] > 0
    records = dit_protocol.main(["--dim", "64", "--layers", "1", "--sizes", "1,8,8;1,8,16", "--steps", "2",
                                 "--device", "cpu"])
    assert [r["tokens"] for r in records] == [16, 32]
    if not torch.cuda.is_available():  # the card is the default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_dit_perf(dim=64, layers=1, sizes=((1, 8, 8),), steps=2)
