"""Port parity for the serving loops: speculative decoding and continuous
batching, on small fp32 models whose weights come from the JAX package.

Speculative decoding (the fixture of the JAX package's
``tests/base/test_speculative.py``: a 3-layer target and a 1-layer draft
that shares the target's layer 0, embedding, norm and lm_head): greedy
``generate`` and ``generate_fused`` emit exactly the JAX target's vanilla
greedy tokens, with the truncated, w8a8 and w4a8 drafts alike. Continuous
batching (the JAX package's ``tests/base/test_continuous_batching.py``):
every request's tokens equal standalone greedy decoding of its prompt, for
each feature of the batcher. Token streams are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mojo_opset_tpu.modeling.qwen3 import Qwen3Config as JaxQwen3Config
from mojo_opset_tpu.modeling.qwen3 import Qwen3ForCausalLM as JaxQwen3
from mojo_opset_tpu.runtime import GreedySampler as JaxGreedy
from mojo_opset_tpu.runtime import MojoGenerator as JaxGenerator
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM, quantize_qwen3
from mojo_opset_tpu_torch.runtime import (
    ContinuousBatchingGenerator,
    GreedySampler,
    MojoGenerator,
    PagedAttentionGenerationModel,
    SpeculativeContinuousBatchingGenerator,
    SpeculativeDecoder,
    TopKSampler,
)
from mojo_opset_tpu_torch.utils.weights import load_numpy_state

BLOCK = 16


def _config(layers, hidden=64, vocab=256, max_pos=512):
    return dict(hidden_size=hidden, intermediate_size=hidden * 2, num_attention_heads=4, num_key_value_heads=2,
                num_hidden_layers=layers, head_dim=hidden // 4, vocab_size=vocab, max_position_embeddings=max_pos)


def _port_of(jax_model, config):
    port = Qwen3ForCausalLM(Qwen3Config(**config, dtype=torch.float32), device="cpu")
    return load_numpy_state(port, state_dict_of(jax_model))


def _greedy(model, ids, lens, steps):
    gen = MojoGenerator(PagedAttentionGenerationModel(model, block_size=BLOCK), None, GreedySampler(),
                        max_new_tokens=steps)
    return gen.generate_from_ids(ids, np.asarray(lens, np.int32), ignore_eos=True)


# ---------------------------------------------------------------- speculative decoding


@pytest.fixture(scope="module")
def spec_models():
    """(JAX target, port target with its weights, port 1-layer draft)."""
    target_j = JaxQwen3(JaxQwen3Config(**_config(3), dtype=jnp.float32), key=jax.random.PRNGKey(0))
    target = _port_of(target_j, _config(3))
    draft = Qwen3ForCausalLM(Qwen3Config(**_config(1), dtype=torch.float32), device="meta")
    draft.model.embed_tokens = target.model.embed_tokens
    draft.model.layers[0] = target.model.layers[0]
    draft.model.norm = target.model.norm
    draft.model.rotary_emb = target.model.rotary_emb
    draft.lm_head = target.lm_head
    return target_j, target, draft


IDS = np.array([5, 9, 2, 88, 41, 6, 100, 64, 31, 7], np.int32)
LENS = np.array([6, 4], np.int32)


def _jax_greedy(target_j, ids, lens, steps):
    gen = JaxGenerator(JaxPaged(target_j, block_size=BLOCK, jit=False), None, JaxGreedy(), max_new_tokens=steps)
    return np.asarray(gen.generate_from_ids(ids, np.asarray(lens, np.int32), ignore_eos=True, silent=True))


@pytest.fixture(scope="module")
def want_two(spec_models):
    return _jax_greedy(spec_models[0], IDS, LENS, 12)


@pytest.mark.parametrize("fused", [False, True], ids=["generate", "generate_fused"])
def test_greedy_speculative_equals_jax_vanilla_greedy(spec_models, want_two, fused):
    _, target, draft = spec_models
    spec = SpeculativeDecoder(target, draft, k=3, mode="greedy", block_size=BLOCK)
    got = (spec.generate_fused if fused else spec.generate)(IDS, LENS, max_new_tokens=12)
    np.testing.assert_array_equal(got, want_two)
    assert 1 < spec.last_rounds < 11  # the truncated draft is accepted in part


def test_self_draft_accepts_everything(spec_models):
    _, target, _ = spec_models
    spec = SpeculativeDecoder(target, target, k=3, block_size=BLOCK)
    got = spec.generate(IDS[:5], [5], max_new_tokens=9)
    np.testing.assert_array_equal(got, _greedy(target, IDS[:5], [5], 9))
    assert spec.last_rounds <= 3  # 1 prefill token + 2 rounds of k + 1


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"], ids=["w8a8", "w4a8"])
@pytest.mark.parametrize("fused", [False, True], ids=["generate", "generate_fused"])
def test_quantized_drafts_are_lossless(spec_models, weight_dtype, fused):
    target_j, target, _ = spec_models
    draft = quantize_qwen3(target, weight_dtype=weight_dtype)
    assert (draft.model.layers[0].mlp.gate_proj.weight_dtype == "int4") == (weight_dtype == "int4")
    spec = SpeculativeDecoder(target, draft, k=4, block_size=BLOCK)
    got = (spec.generate_fused if fused else spec.generate)(IDS[:6], [6], max_new_tokens=10)
    np.testing.assert_array_equal(got, _jax_greedy(target_j, IDS[:6], [6], 10))
    assert spec.last_rounds <= 6


@pytest.mark.parametrize("fused", [False, True], ids=["generate", "generate_fused"])
def test_speculative_eos_clamping(spec_models, fused):
    _, target, draft = spec_models
    spec = SpeculativeDecoder(target, draft, k=3, block_size=BLOCK)
    run = spec.generate_fused if fused else spec.generate
    free = run(IDS[:6], [6], max_new_tokens=10)
    eos = int(free[0, 3])
    out = run(IDS[:6], [6], max_new_tokens=10, eos_token_id=eos)
    first = int(np.nonzero(out[0] == eos)[0][0])
    np.testing.assert_array_equal(out[0, :first + 1], free[0, :first + 1])
    assert (out[0, first:] == eos).all()


def test_reject_mode_is_seeded(spec_models):
    _, target, draft = spec_models
    spec = SpeculativeDecoder(target, draft, k=3, mode="reject", block_size=BLOCK)
    a = spec.generate(IDS[:4], [4], max_new_tokens=8, generator=torch.Generator().manual_seed(7))
    b = spec.generate(IDS[:4], [4], max_new_tokens=8, generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(a, b)
    assert ((0 <= a) & (a < 256)).all()
    np.testing.assert_array_equal(spec.generate(IDS[:4], [4], max_new_tokens=8), spec.generate(IDS[:4], [4], 8))
    with pytest.raises(ValueError, match="greedy mode only"):
        spec.fused_window(spec.new_sessions(1), torch.zeros(1, dtype=torch.int32), 1)


def test_round_rolls_back_and_reuses_blocks(spec_models):
    _, target, draft = spec_models
    spec = SpeculativeDecoder(target, draft, k=3, block_size=BLOCK)
    sessions = spec.new_sessions(2)
    cur = spec.prefill(sessions, IDS, LENS)
    emitted, counts, _ = spec.round(sessions, cur)
    assert emitted.shape == (2, 4) and ((1 <= counts) & (counts <= 4)).all()
    for session in sessions:
        np.testing.assert_array_equal(session.total_seq_lens, LENS + counts)
    free = sessions[0].free_block_count()
    spec.round(sessions, cur)
    assert sessions[0].free_block_count() == free  # the rolled-back reserve's blocks are reused


# ---------------------------------------------------------------- continuous batching


@pytest.fixture(scope="module")
def cb_model():
    model_j = JaxQwen3(JaxQwen3Config(**_config(2, max_pos=256), dtype=jnp.float32), key=jax.random.PRNGKey(13))
    return model_j, _port_of(model_j, _config(2, max_pos=256))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, (int(n),)).astype(np.int32) for n in lens]


def _standalone(model, prompt, steps):
    return _greedy(model, prompt, [prompt.size], steps)[0]


def _check_all(model, gen, prompts, steps):
    rids = [gen.submit(p) for p in prompts]
    results = gen.run()
    assert sorted(results) == sorted(rids)
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(results[rid], _standalone(model, p, steps), err_msg=f"request {rid}")
    return gen


def test_standalone_greedy_equals_jax(cb_model):
    model_j, model = cb_model
    p = _prompts(5, (9,))[0]
    np.testing.assert_array_equal(_standalone(model, p, 6), _jax_greedy(model_j, p, [9], 6)[0])


CB_FEATURES = {
    "more_requests_than_slots": (dict(batch_slots=3), (5, 9, 3, 7, 4, 11, 6), 6),
    "decode_window": (dict(batch_slots=2, decode_window=3), (5, 9, 3, 7, 4), 7),
    "bucket_admits": (dict(batch_slots=2, bucket_admits=True), (5, 9, 3, 7, 4), 6),
    "chunked_prefill": (dict(batch_slots=2, max_prefill_chunk=8), (23, 4, 17, 9), 5),
    "chunked_prefill_buckets": (dict(batch_slots=2, max_prefill_chunk=8, bucket_admits=True), (19, 6), 4),
}


@pytest.mark.parametrize("feature", sorted(CB_FEATURES))
def test_continuous_batching_matches_standalone(cb_model, feature):
    kw, lens, steps = CB_FEATURES[feature]
    model = cb_model[1]
    gen = ContinuousBatchingGenerator(model, block_size=BLOCK, max_new_tokens=steps, **kw)
    _check_all(model, gen, _prompts(5, lens), steps)


@pytest.mark.parametrize("window", [1, 3])
def test_eos_frees_slot_early(cb_model, window):
    model = cb_model[1]
    p0, p1 = _prompts(9, (6, 4))
    ref = _standalone(model, p0, 8)
    eos = int(ref[2 if window == 1 else 4])
    gen = ContinuousBatchingGenerator(model, batch_slots=1, block_size=BLOCK, max_new_tokens=8, eos_token_id=eos,
                                      decode_window=window)
    r0, r1 = gen.submit(p0), gen.submit(p1)  # request 1 waits for slot 0
    results = gen.run()
    np.testing.assert_array_equal(results[r0], ref[:list(ref).index(eos) + 1])
    got1 = results[r1]
    np.testing.assert_array_equal(got1, _standalone(model, p1, 8)[:len(got1)])


def test_second_run_reuses_session(cb_model):
    model = cb_model[1]
    gen = ContinuousBatchingGenerator(model, batch_slots=2, block_size=BLOCK, max_new_tokens=4)
    p = _prompts(2, (5,))[0]
    r0 = gen.submit(p)
    first = gen.run()
    session, free = gen.session, gen.session.free_block_count()
    r1 = gen.submit(p)
    np.testing.assert_array_equal(first[r0], gen.run()[r1])
    assert gen.session is session and session.free_block_count() == free


def test_sampler_is_seeded(cb_model):
    model = cb_model[1]
    prompts = _prompts(3, (5, 8, 4))

    def run(seed):
        gen = ContinuousBatchingGenerator(model, batch_slots=2, block_size=BLOCK, max_new_tokens=5,
                                          sampler=TopKSampler(10), seed=seed)
        rids = [gen.submit(p) for p in prompts]
        results = gen.run()
        return np.stack([results[r] for r in rids])

    a = run(42)
    np.testing.assert_array_equal(a, run(42))
    assert ((0 <= a) & (a < 256)).all() and not np.array_equal(a, run(43))
    with pytest.raises(ValueError, match="greedy"):
        ContinuousBatchingGenerator(model, sampler=TopKSampler(10), decode_window=2)


def test_prefix_cache_hits_and_stays_exact(cb_model):
    model = cb_model[1]
    rng = np.random.default_rng(21)
    base = rng.integers(1, 256, (37,)).astype(np.int32)
    p0, p2, p3 = base.copy(), base[:35].copy(), rng.integers(1, 256, (20,)).astype(np.int32)
    p1 = np.concatenate([base[:33], rng.integers(1, 256, (6,)).astype(np.int32)])
    gen = ContinuousBatchingGenerator(model, batch_slots=1, block_size=BLOCK, max_new_tokens=5,
                                      prefix_cache_blocks=8)
    _check_all(model, gen, [p0], 5)
    assert gen._prefix_owned == 2  # floor(37 / 16) blocks donated
    free = gen.session.free_block_count()
    _check_all(model, gen, [p1, p2, p3], 5)  # p1 and p2 hit the 2-block prefix
    assert gen._prefix_owned <= 8 and len(gen._prefix_block_ids) == gen._prefix_owned
    assert gen.session.free_block_count() == free - (gen._prefix_owned - 2)


def test_prefix_cache_budget_and_duplicates(cb_model):
    model = cb_model[1]
    rng = np.random.default_rng(22)
    gen = ContinuousBatchingGenerator(model, batch_slots=1, block_size=BLOCK, max_new_tokens=3,
                                      prefix_cache_blocks=2)
    for _ in range(3):  # each 37-token prompt would donate 2 blocks
        gen.submit(rng.integers(1, 256, (37,)).astype(np.int32))
    gen.run()
    assert gen._prefix_owned == 2
    prompt = rng.integers(1, 256, (37,)).astype(np.int32)
    gen = ContinuousBatchingGenerator(model, batch_slots=2, block_size=BLOCK, max_new_tokens=3,
                                      prefix_cache_blocks=16)
    _check_all(model, gen, [prompt, prompt], 3)  # admitted together: both miss, one donates
    free = gen.session.free_block_count()
    assert gen._prefix_owned == 2
    _check_all(model, gen, [prompt, prompt], 3)
    assert gen._prefix_owned == 2 and gen.session.free_block_count() == free  # no block leaked


def test_speculative_batcher_matches_standalone(cb_model):
    model = cb_model[1]
    gen = SpeculativeContinuousBatchingGenerator(model, quantize_qwen3(model, weight_dtype="int4"), speculative_k=3,
                                                 batch_slots=2, block_size=BLOCK, max_new_tokens=7)
    _check_all(model, gen, _prompts(7, (5, 9, 3, 7, 4)), 7)


def test_speculative_batcher_eos(cb_model):
    model = cb_model[1]
    p0 = _prompts(9, (6,))[0]
    ref = _standalone(model, p0, 8)
    eos = int(ref[4])
    gen = SpeculativeContinuousBatchingGenerator(model, quantize_qwen3(model), speculative_k=3, batch_slots=1,
                                                 block_size=BLOCK, max_new_tokens=8, eos_token_id=eos)
    r0 = gen.submit(p0)
    np.testing.assert_array_equal(gen.run()[r0], ref[:list(ref).index(eos) + 1])


@pytest.mark.parametrize("kwargs,match", [
    (dict(sampler=TopKSampler(5)), "greedy-only"),
    (dict(bucket_admits=True), "bucket_admits"),
    (dict(max_prefill_chunk=8), "chunked-prefill"),
    (dict(prefix_cache_blocks=4), "prefix caching"),
])
def test_speculative_batcher_rejects_unsupported(cb_model, kwargs, match):
    model = cb_model[1]
    with pytest.raises(ValueError, match=match):
        SpeculativeContinuousBatchingGenerator(model, model, batch_slots=1, block_size=BLOCK, **kwargs)


def test_empty_prompt_rejected(cb_model):
    gen = ContinuousBatchingGenerator(cb_model[1], batch_slots=1, block_size=BLOCK)
    with pytest.raises(ValueError, match="empty prompt"):
        gen.submit(np.array([], np.int32))
