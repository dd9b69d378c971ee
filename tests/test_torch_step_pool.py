"""The port's compiled-step pool (``runtime/compile_cache.py``) held to the
JAX package's ``tests/base/test_compile_cache.py``, on the CPU.

CUDA graphs need the card, so here: the pool's keys (one per signature;
batch, dtype and cache structure change it, and so does a new session's
cache storage, which a graph bakes in), ``round_up_bucket`` equal to JAX's,
``MojoRunTimeConfig`` equal to JAX's, the CPU refusals (``get_runner`` and
``device_graph=True``), a CPU session's default running eagerly with JAX's
tokens, and the replay credit of the launch counters and ``golden_calls``
through the bookkeeping that a capture uses. chip_smoke.py phase 17 runs
the graphs themselves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.modeling.qwen3 import Qwen3Config as JaxQwen3Config
from mojo_opset_tpu.modeling.qwen3 import Qwen3ForCausalLM as JaxQwen3
from mojo_opset_tpu.runtime import GreedySampler as JaxGreedy
from mojo_opset_tpu.runtime import MojoGenerator as JaxGenerator
from mojo_opset_tpu.runtime import MojoRunTimeConfig as JaxRunTimeConfig
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.runtime import round_up_bucket as jax_round_up_bucket
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.backends.cuda import kernels
from mojo_opset_tpu_torch.backends.cuda.operators import CudaPagedDecodeGQA, CudaQuantGemm
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
from mojo_opset_tpu_torch.runtime import (
    CompiledStepPool,
    ContinuousBatchingGenerator,
    FusedDecode,
    GreedySampler,
    MojoConfig,
    MojoGenerator,
    MojoRunTimeConfig,
    PagedAttentionGenerationModel,
    PagedAttentionRuntimeState,
    SpeculativeDecoder,
    round_up_bucket,
)
from mojo_opset_tpu_torch.runtime.compile_cache import resolve_device_graph
from mojo_opset_tpu_torch.runtime.session import KVCaches
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

TINY = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
            num_hidden_layers=2, head_dim=16, vocab_size=128, max_position_embeddings=128)


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX tiny Qwen3, the port's with its weights)."""
    model_j = JaxQwen3(JaxQwen3Config(**TINY, dtype=jnp.float32), key=jax.random.PRNGKey(7))
    port = Qwen3ForCausalLM(Qwen3Config(**TINY, dtype=torch.float32), device="cpu")
    return model_j, load_numpy_state(port, state_dict_of(model_j))


def _caches(batch, dtype=torch.float32, layers=2):
    return KVCaches.create(layers, (batch * 4, 2, 8, 16), dtype, "cpu")


def _decode_pool():
    return CompiledStepPool(lambda caches, ids, lens: None, donate_argnums=(0,))


# ---------------------------------------------------------------- the pool's keys


def test_same_signature_is_one_key():
    pool, caches = _decode_pool(), _caches(2)
    a = pool.signature(caches, torch.zeros(2, dtype=torch.int32), torch.tensor([3, 4], dtype=torch.int32))
    b = pool.signature(caches, torch.ones(2, dtype=torch.int32), torch.tensor([9, 1], dtype=torch.int32))
    assert a == b and hash(a) == hash(b)


@pytest.mark.parametrize("change", ["batch", "dtype", "cache_structure", "new_session"])
def test_signature_changes(change):
    pool, caches = _decode_pool(), _caches(2)
    ids, lens = torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    base = pool.signature(caches, ids, lens)
    if change == "batch":
        other = pool.signature(caches, torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32))
    elif change == "dtype":
        other = pool.signature(caches, ids.long(), lens)
    elif change == "cache_structure":
        other = pool.signature(_caches(2, layers=3), ids, lens)
    else:  # a new session's caches: the same shapes, other storage
        other = pool.signature(_caches(2), ids, lens)
    assert other != base


def test_signature_keys_int8_caches_and_static_args():
    pool = CompiledStepPool(lambda caches, ids, n: None, donate_argnums=(0,), static_argnums=(2,))
    caches8 = _caches(2, torch.int8)
    ids = torch.zeros(2, dtype=torch.int32)
    assert pool.signature(caches8, ids, 4) != pool.signature(_caches(2), ids, 4)  # its scales and dtype
    assert pool.signature(caches8, ids, 4) != pool.signature(caches8, ids, 5)
    assert pool.signature(caches8, ids, 4) == pool.signature(caches8, ids, 4)


def test_round_up_bucket_equals_jax():
    for n in range(0, 20001):
        assert round_up_bucket(n) == jax_round_up_bucket(n)
    for buckets in ((8,), (3, 7, 100), (16, 48)):
        for n in range(0, 700):
            assert round_up_bucket(n, buckets) == jax_round_up_bucket(n, buckets)


def test_continuous_batcher_takes_the_pool_buckets():
    from mojo_opset_tpu_torch.runtime import continuous

    assert continuous.round_up_bucket is round_up_bucket
    assert continuous.ADMIT_BUCKETS == (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def test_runtime_config_equals_jax():
    port = [(f.name, f.default) for f in dataclasses.fields(MojoRunTimeConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(JaxRunTimeConfig)]
    assert port == want
    assert isinstance(MojoConfig().runtime_config, MojoRunTimeConfig)
    assert Qwen3Config(**TINY).to_mojo().runtime_config.use_device_graph  # the port's models switch graphs on


# ---------------------------------------------------------------- the CPU refusals and default


def test_get_runner_raises_on_cpu():
    pool = _decode_pool()
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        pool.get_runner(_caches(2), torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    step = CompiledStepPool(lambda x: x * 2, donate_argnums=())
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        step.get_runner(torch.ones(3))


def test_device_graph_true_raises_on_cpu(tiny_pair):
    _, model = tiny_pair
    with pytest.raises(ValueError, match="device_graph=True needs a model on the card"):
        PagedAttentionGenerationModel(model, block_size=16, device_graph=True)
    with pytest.raises(ValueError, match="device_graph=True"):
        FusedDecode(model, device_graph=True)
    with pytest.raises(ValueError, match="device_graph=True"):
        SpeculativeDecoder(model, model, k=2, block_size=16, device_graph=True)
    with pytest.raises(ValueError, match="device_graph=True"):
        ContinuousBatchingGenerator(model, batch_slots=2, block_size=16, device_graph=True)


def test_config_switch_and_cpu_default(tiny_pair):
    _, model = tiny_pair
    assert resolve_device_graph(None, model) is False  # a CPU session runs eagerly
    assert resolve_device_graph(False, model) is False
    assert PagedAttentionGenerationModel(model, block_size=16).device_graph is False
    meta = Qwen3ForCausalLM(Qwen3Config(**TINY), device="meta")
    assert resolve_device_graph(None, meta) is False  # not on the card


def test_cpu_default_runs_eagerly_with_jax_tokens(tiny_pair):
    model_j, model = tiny_pair
    ids, lens = np.arange(1, 12, dtype=np.int32), np.array([7, 4], np.int32)
    want = JaxGenerator(JaxPaged(model_j, block_size=16, jit=False), None, JaxGreedy(), max_new_tokens=8)
    want = np.asarray(want.generate_from_ids(ids, lens, ignore_eos=True, silent=True))
    gm = PagedAttentionGenerationModel(model, block_size=16)
    gen = MojoGenerator(gm, None, GreedySampler(), max_new_tokens=8)
    for fused in (False, True):
        np.testing.assert_array_equal(gen.generate_from_ids(ids, lens, ignore_eos=True, fused_decode=fused), want)
    assert gm.runners() == [] and gen._session is None  # no graph, and a new session each call


def test_renew_equals_a_new_session(tiny_pair):
    _, model = tiny_pair
    session = PagedAttentionRuntimeState.from_model(model, 2, block_size=16)
    gm = PagedAttentionGenerationModel(model, block_size=16)
    gm(np.arange(1, 30, dtype=np.int32), context_input_len=np.array([20, 9], np.int32), session=session)
    session.release_sequence(1)
    session.renew()
    fresh = PagedAttentionRuntimeState.from_model(model, 2, block_size=16)
    for name in ("block_tables", "total_seq_lens", "free_blocks"):
        np.testing.assert_array_equal(getattr(session, name), getattr(fresh, name))
    assert session.num_free_blocks == fresh.num_free_blocks


# ---------------------------------------------------------------- replay credit


def test_recorded_counts_are_taken_back_and_credited_per_replay():
    kernels.reset_launch_counts()
    kernels.int4_matmul.launches_by_route["decode", 1] += 2
    golden_before = CudaPagedDecodeGQA.golden_calls
    with kernels.recorded_counts() as record:  # what a capture's wrappers count
        kernels.norms.launches += 3
        kernels.paged_decode.launches += 1
        kernels.int4_matmul.launches_by_route["decode", 1] += 1
        kernels.int4_matmul.launches_by_route["wgmma", 32] += 4
        kernels.group_quant_gemm.launches_by_route["decode"] = 2
        CudaPagedDecodeGQA.golden_calls += 1
    # the capture launched nothing: every counter is back
    assert kernels.launch_counts()["norms"] == 0 and kernels.launch_counts()["paged_decode"] == 0
    assert dict(kernels.int4_matmul.launches_by_route) == {("decode", 1): 2}
    assert kernels.group_quant_gemm.launches_by_route == {}
    assert CudaPagedDecodeGQA.golden_calls == golden_before
    assert len(record) == 6
    for replays in (1, 2):  # each replay adds the record once
        kernels.credit_counts(record)
        counts = kernels.launch_counts()
        assert counts["norms"] == 3 * replays and counts["paged_decode"] == replays
        assert kernels.int4_matmul.launches_by_route["decode", 1] == 2 + replays
        assert kernels.int4_matmul.launches_by_route["wgmma", 32] == 4 * replays
        assert kernels.group_quant_gemm.launches_by_route["decode"] == 2 * replays
        assert CudaPagedDecodeGQA.golden_calls == golden_before + replays
    kernels.credit_counts(record, times=3)
    assert kernels.launch_counts()["norms"] == 15
    CudaPagedDecodeGQA.golden_calls = golden_before
    kernels.reset_launch_counts()


def test_count_state_covers_every_counter():
    state = kernels.count_state()
    for _, module, attr in kernels.COUNTERS:
        assert (module, attr, None) in state
    assert (CudaQuantGemm, "golden_calls", None) in state
    assert all(cls.__name__.startswith(("Cuda", "_")) for cls in kernels.golden_classes())


def test_module_path_names_the_failing_op_and_keeps_outputs():
    from mojo_opset_tpu_torch.runtime.compile_cache import _ModulePath

    class Fails(torch.nn.Module):
        def forward(self, x):
            raise RuntimeError("operation not permitted when stream is capturing")

    inner = torch.nn.Linear(3, 3)
    outer = torch.nn.Sequential(inner, torch.nn.ReLU())
    x = torch.ones(2, 3)
    with _ModulePath() as path:
        y = outer(x)
    assert torch.equal(y, outer(x)) and str(path) == "the step function outside any module"
    with pytest.raises(RuntimeError, match="not permitted"), _ModulePath() as path:
        torch.nn.Sequential(inner, Fails())(x)
    assert str(path) == "Sequential > Fails"


# ---------------------------------------------------------------- the runtime's wiring, graphs emulated


@pytest.fixture
def emulated_graphs(monkeypatch):
    """The pool on CPU tensors with its graph emulated: a capture records the step, a replay reruns it on the
    static buffers (what a CUDA graph replays). Everything else (keys, static copies, warm-up, the sessions the
    entry points keep) is the pool's own."""
    from mojo_opset_tpu_torch.runtime import compile_cache, session, speculative

    class Replay:
        def __init__(self, runner, inputs):
            self.runner, self.inputs = runner, inputs

        def replay(self):
            self.runner.out = self.runner.pool._step_fn(*self.inputs)

    def capture(runner, inputs):
        with kernels.recorded_counts() as record:
            pass
        runner.graph, runner.credit, runner.capture_ms = Replay(runner, inputs), record, 0.0

    for module in (compile_cache, session, speculative):
        monkeypatch.setattr(module, "resolve_device_graph", lambda device_graph, model: device_graph is not False)
    monkeypatch.setattr(compile_cache.CompiledStepPool, "_device", lambda self, args: torch.device("cpu"))
    monkeypatch.setattr(compile_cache.StepRunner, "_warm_up", lambda self, inputs: self.pool._step_fn(*inputs))
    monkeypatch.setattr(compile_cache.StepRunner, "_capture", capture)


def _runners(*pools):
    return [r for pool in pools if pool is not None for r in pool.runners()]


@pytest.mark.parametrize("path", ["stepwise", "fused", "topk_fused", "speculative", "continuous_windows"])
def test_emulated_graphs_give_eager_tokens(tiny_pair, emulated_graphs, path):
    from mojo_opset_tpu_torch.runtime import TopKSampler

    _, model = tiny_pair
    ids, lens = np.arange(1, 30, dtype=np.int32) % 120 + 1, np.array([20, 9], np.int32)
    if path in ("stepwise", "fused", "topk_fused"):
        sampler = TopKSampler(8) if path == "topk_fused" else GreedySampler()
        runs = {}
        for graphs in (False, None):
            gen = MojoGenerator(PagedAttentionGenerationModel(model, block_size=16, device_graph=graphs), None,
                                sampler, max_new_tokens=10, seed=3)
            runs[graphs] = [gen.generate_from_ids(ids, lens, ignore_eos=True, fused_decode=path != "stepwise")
                            for _ in range(3)]
        for want, got in zip(runs[False], runs[None]):
            np.testing.assert_array_equal(got, want)
        pools = [gen.model._pool] + [f._pool for f in gen._fused.values()]
    elif path == "speculative":
        want = MojoGenerator(PagedAttentionGenerationModel(model, block_size=16, device_graph=False), None,
                             GreedySampler(), max_new_tokens=10).generate_from_ids(ids, lens, ignore_eos=True)
        spec = SpeculativeDecoder(model, model, k=3, block_size=16)
        for run in (spec.generate, spec.generate_fused, spec.generate):
            np.testing.assert_array_equal(run(ids, lens, max_new_tokens=10), want)
        pools = [spec._draft_pool, spec._verify_pool]
    else:
        prompts = [np.arange(3, 3 + n, dtype=np.int32) for n in (5, 30, 9)]
        out = {}
        for graphs in (False, None):
            server = ContinuousBatchingGenerator(model, batch_slots=2, block_size=16, max_new_tokens=9,
                                                 decode_window=4, device_graph=graphs)
            rids = [server.submit(p) for p in prompts]
            results = server.run()
            out[graphs] = [results[r] for r in rids]
        for want, got in zip(out[False], out[None]):
            np.testing.assert_array_equal(got, want)
        pools = [server.gm._pool, server._fused._pool]
    replayed = [r for r in _runners(*pools) if r.graph is not None]
    assert replayed and all(r.calls >= 2 for r in replayed)
