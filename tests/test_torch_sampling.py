"""Port parity for the sampling ops and the samplers of the runtime.

The deterministic parts are compared with the JAX ops on the same numpy
inputs: top-k values and indices, the nucleus-filtered distributions, the
penalties and the temperature. JAX's ``key`` and the port's
``torch.Generator`` draw different numbers, so the speculative acceptance
ops are compared through their pure helpers fed JAX's own uniforms, and
the sampling draws are held to their distributions by a chi-square test.

Tolerances, and why:
  * indices, accepted lengths and tokens: equal;
  * probabilities, penalties, temperature: rtol 1e-6, atol 1e-7 (one fp32
    softmax or subtraction, reduced in another order);
  * chi-square: p > 1e-3 with a seeded generator (the test is
    deterministic; the bound only says the draw fits its distribution).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import mojo_opset_tpu as jm
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu_torch.core.operators.sampling import (
    join_prob_reject_from_uniform,
    reject_sampling_from_uniform,
    sample_from_uniform,
)
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
from mojo_opset_tpu_torch.runtime import (
    FusedDecode,
    GreedySampler,
    MojoGenerator,
    PagedAttentionGenerationModel,
    TopKSampler,
)
from mojo_opset_tpu_torch.utils.acc import check_tol_diff

PROB = dict(atol=1e-7, rtol=1e-6)


def jax_op(core, *args, **kwargs):
    return core.get_backend_impl("ref", strict=True)(*args, **kwargs)


def _logits(seed, shape, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("top_p,min_keep,rand_top_k", [(0.8, 1, 50), (0.5, 4, 20), (0.99, 1, 64), (0.3, 1, 1)])
def test_top_p_filter_matches_jax(top_p, min_keep, rand_top_k):
    logits = _logits(50, (5, 64))
    probs_j, idx_j = jax_op(jm.MojoTopPFilter)(jnp.asarray(logits), top_p, min_keep, rand_top_k)
    probs_t, idx_t = tm.MojoTopPFilter()(torch.from_numpy(logits), top_p, min_keep, rand_top_k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    check_tol_diff(probs_t, np.asarray(probs_j), **PROB)


def test_top_k_candidates_match_jax():
    """The sampled token comes from JAX's top-k set, with the probability
    JAX's softmax over that set gives it."""
    logits = _logits(51, (16, 100), scale=3.0)
    vals_j, idx_j = jax.lax.top_k(jnp.asarray(logits), 5)
    probs_j = np.asarray(jax.nn.softmax(vals_j, axis=-1))
    probs_t, tokens_t = tm.MojoTopKSampling(top_k=5)(torch.from_numpy(logits), torch.Generator().manual_seed(1))
    assert probs_t.shape == tokens_t.shape == (16, 1)
    for row in range(16):
        pos = list(np.asarray(idx_j[row])).index(int(tokens_t[row, 0]))
        check_tol_diff(probs_t[row, 0], probs_j[row, pos], **PROB)


def test_sample_from_uniform_is_the_inverse_cdf():
    probs = torch.tensor([[0.0, 0.25, 0.0, 0.75], [0.5, 0.5, 0.0, 0.0]])
    u = torch.tensor([[0.0], [0.9999]])
    assert sample_from_uniform(probs, u).tolist() == [[1], [1]]  # zero-probability indices are never taken
    assert sample_from_uniform(probs, torch.tensor([[0.3], [0.49]])).tolist() == [[3], [0]]


def _chi_square_p(tokens: np.ndarray, support: np.ndarray, expected: np.ndarray) -> float:
    assert np.isin(tokens, support).all(), "a token outside the filtered support"
    counts = np.array([(tokens == t).sum() for t in support])
    expected = np.asarray(expected, np.float64)
    return float(stats.chisquare(counts, expected / expected.sum() * counts.sum()).pvalue)


def test_top_k_sampling_frequencies():
    row = _logits(52, (12,), scale=1.0)
    n = 20000
    _, tokens = tm.MojoTopKSampling(top_k=5)(torch.from_numpy(np.tile(row, (n, 1))),
                                             torch.Generator().manual_seed(2))
    vals, idx = jax.lax.top_k(jnp.asarray(row), 5)
    p = _chi_square_p(tokens.numpy()[:, 0], np.asarray(idx), np.asarray(jax.nn.softmax(vals)))
    assert p > 1e-3, p


def test_top_p_sampling_frequencies():
    row = _logits(53, (12,), scale=1.0)
    n = 20000
    op = tm.MojoTopPSampling(top_p=0.7, rand_top_k=8)
    probs_t, tokens = op(torch.from_numpy(np.tile(row, (n, 1))), torch.Generator().manual_seed(3))
    filtered, idx = jax_op(jm.MojoTopPFilter)(jnp.asarray(row[None]), 0.7, 1, 8)
    filtered, idx = np.asarray(filtered)[0], np.asarray(idx)[0]
    keep = filtered > 0
    p = _chi_square_p(tokens.numpy()[:, 0], idx[keep], filtered[keep])
    assert p > 1e-3, p
    assert (probs_t > 0).all()


def _spec_case(seed, B=6, S=4, V=12):
    rng = np.random.default_rng(seed)
    target = rng.random((B, S + 1, V)).astype(np.float32)
    target /= target.sum(-1, keepdims=True)
    draft_tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    draft_probs = rng.uniform(0.05, 0.3, (B, S)).astype(np.float32)
    return target, draft_tokens, draft_probs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reject_sampling_matches_jax_with_its_uniforms(seed):
    target, d_tok, d_p = _spec_case(60 + seed)
    key = jax.random.PRNGKey(seed)
    tokens_j, acc_j = jax_op(jm.MojoRejectSampling)(jnp.asarray(target), jnp.asarray(d_tok), jnp.asarray(d_p), key=key)
    u = np.array(jax.random.uniform(key, (target.shape[0], 1)))  # the op's own draw
    tokens_t, acc_t = reject_sampling_from_uniform(*(torch.from_numpy(a) for a in (target, d_tok, d_p, u)))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(tokens_t.numpy(), np.asarray(tokens_j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_prob_reject_sampling_matches_jax_with_its_uniforms(seed):
    target, d_tok, d_p = _spec_case(70 + seed)  # ratios above and below 1
    key = jax.random.PRNGKey(seed)
    tokens_j, acc_j = jax_op(jm.MojoJoinProbRejectSampling)(jnp.asarray(target), jnp.asarray(d_tok),
                                                            jnp.asarray(d_p), key=key)
    u = np.array(jax.random.uniform(key, d_p.shape))
    tokens_t, acc_t = join_prob_reject_from_uniform(*(torch.from_numpy(a) for a in (target, d_tok, d_p, u)))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(tokens_t.numpy(), np.asarray(tokens_j))


def test_reject_ops_accept_all_and_none():
    B, S, V = 2, 3, 10
    d_tok = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    d_p = torch.full((B, S), 0.5)
    sure = torch.zeros(B, S + 1, V)
    sure[torch.arange(B)[:, None], torch.arange(S)[None, :], d_tok.long()] = 1.0
    for op in (tm.MojoRejectSampling(), tm.MojoJoinProbRejectSampling()):
        tokens, acc = op(sure, d_tok, d_p, torch.Generator().manual_seed(0))
        assert tokens.shape == (B, S + 1) and acc.tolist() == [S, S]
    _, acc = tm.MojoRejectSampling()(torch.zeros(B, S + 1, V), d_tok, d_p, torch.Generator().manual_seed(0))
    assert acc.tolist() == [0, 0]


def test_penalties_and_temperature_match_jax():
    rng = np.random.default_rng(80)
    V = 32
    logits = _logits(81, (4, V))
    freqs = [rng.integers(0, 3, V).astype(np.float32), None, rng.integers(0, 2, V).astype(np.float32),
             np.zeros(V, np.float32)]
    args = dict(presence_penalties=[0.5, 0.0, 0.0, 0.3], frequency_penalties=[0.25, 0.0, 0.1, 0.0],
                repetition_penalties=[1.3, 1.0, 0.8, 1.2], temps=[None, 2.0, 0.7, None])
    want = jax_op(jm.MojoApplyPenaltiesTempurate)(
        jnp.asarray(logits), [None if f is None else jnp.asarray(f) for f in freqs], **args)
    got = tm.MojoApplyPenaltiesTempurate()(
        torch.from_numpy(logits), [None if f is None else torch.from_numpy(f) for f in freqs], **args)
    check_tol_diff(got, np.asarray(want), **PROB)
    got16 = tm.MojoApplyPenaltiesTempurate()(torch.from_numpy(logits).to(torch.bfloat16), [None] * 4, **args)
    assert got16.dtype == torch.bfloat16


# ---------------------------------------------------------------- the samplers


@pytest.fixture(scope="module")
def tiny_model():
    cfg = Qwen3Config(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
                      num_hidden_layers=2, head_dim=16, vocab_size=128, max_position_embeddings=128,
                      dtype=torch.float32)
    return Qwen3ForCausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(4))


def _sampled(model, fused, seed, sampler):
    ids, lens = np.arange(1, 12, dtype=np.int32), np.array([4, 7], np.int32)
    gen = MojoGenerator(PagedAttentionGenerationModel(model, block_size=8), None, sampler, max_new_tokens=10,
                        seed=seed)
    return gen.generate_from_ids(ids, lens, ignore_eos=True, fused_decode=fused)


def test_top_k_generation_is_seeded_and_fused_equals_stepwise(tiny_model):
    """One generator, drawn in the same order: the fused window's top-k
    samples equal the stepwise loop's."""
    stepwise = _sampled(tiny_model, False, 5, TopKSampler(8))
    assert np.array_equal(stepwise, _sampled(tiny_model, False, 5, TopKSampler(8)))
    np.testing.assert_array_equal(_sampled(tiny_model, True, 5, TopKSampler(8)), stepwise)
    assert not np.array_equal(stepwise, _sampled(tiny_model, False, 6, TopKSampler(8)))
    greedy = _sampled(tiny_model, False, 5, GreedySampler())
    np.testing.assert_array_equal(_sampled(tiny_model, True, 5, TopKSampler(1)), greedy)


def test_fused_decode_sample_methods(tiny_model):
    with pytest.raises(ValueError, match="unknown sample method"):
        FusedDecode(tiny_model, sample_method="nucleus")
    gm = PagedAttentionGenerationModel(tiny_model, block_size=8)
    logits, session = gm(np.arange(1, 6, dtype=np.int32), context_input_len=np.array([5], np.int32))
    first = torch.argmax(logits, -1).to(torch.int32)
    toks = FusedDecode(tiny_model, sample_method="topk", top_k=3)(session, first, 6)
    assert toks.shape == (6, 1) and toks.dtype == torch.int32
    assert session.total_seq_lens.tolist() == [11]
    session.reset()
    assert session.total_seq_lens.tolist() == [0] and session.free_block_count() == session.free_blocks.size
