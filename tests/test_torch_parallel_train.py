"""Port parity for dp x tp training and the rest of the distributed layer,
against the unsharded JAX model, on the CPU.

One spawn of four gloo rank processes (``tests/torch_parallel_workers.py``)
runs every case; JAX's references are computed in this process:

* one train step (``train_forward``, the vocab-parallel fused linear cross
  entropy, backward, ``parallel.training.finish_gradients``, one
  ``torch.optim.AdamW`` step at optax.adamw(1e-4)'s settings) against
  ``jax.value_and_grad`` of JAX's unsharded step on the whole batch and
  ``optax.adamw(1e-4)``: at dp 2 x tp 2 on ``__graft_entry__.py``'s
  ``_tiny_config`` (fp32, 2 layers, hidden 128, 8/4 heads, head_dim 16,
  vocab 256, an owned LM head); at tp 4 with 2 kv heads (kv replication);
  with a tied LM head whose 250-row vocabulary does not split over 4 ranks
  (the embedding's ceil split by ``shard_embedding``: the rules, as JAX's,
  leave such a vocabulary whole); and at dp 2 x tp 2 with label smoothing,
  a z-loss and ``ignore_index`` rows that fall 3 and 11 on the two dp ranks;
* speculative decoding at tp 4 (a w8a8 draft, ``quantize_qwen3`` then
  sharded, and the fp32 target; JAX tests/distributed/
  test_parallel_styles.py:259's config and PRNGKey 7, k 3, greedy);
* the w8a8 model with the C8 cache at tp 2 and at tp 4 with 2 kv heads;
* the ring AllGatherGemm and GemmReduceScatter at world 4 and 2;
* ``dryrun_step``, the port's ``dryrun_multichip`` on this mesh; and
  ``dryrun_multichip(2)`` itself, spawning its own two gloo ranks (a
  subprocess, as tests/test_torch_launch.py runs its mesh).

Every gradient and parameter is compared by name: each rank's shard against
the same shard of JAX's array, cut by ``shard_model`` on a groupless view of
the rank's mesh coordinates (the slicing ``tests/test_torch_parallel.py``
holds to ``np.split`` along JAX's PartitionSpecs); the rotary ``inv_freq``
is a buffer in the port (a leaf optax decays in JAX) and is left out.

Tolerances, and why:

* the loss to atol = rtol = 1e-5: fp32, the ranks' sums in another order;
* gradients to atol = rtol = 1e-4, the model tolerance of
  ``tests/test_torch_training.py`` (two layers of fp32 products and
  softmaxes, the attention backward recomputed from lse, and here the
  partial gradients summed over the ranks);
* parameters after the step to atol = rtol = 1e-4: the step moves each by
  about lr = 1e-4, its sign the gradient's;
* ranks that share a kv head hold the same ``k_proj`` / ``v_proj`` /
  ``k_norm`` gradients exactly: each reads the one all-reduced sum;
* tokens exactly; the C8 channel scales to rtol = 1e-6 (each rank's kv
  heads' amax, from int8 GEMM sums that are exact);
* the rings to atol = rtol = 1e-5 (fp32 GEMMs on chunks, the partial sums
  added in JAX's ring order).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mojo_opset_tpu as jm
from mojo_opset_tpu.core.functions.loss import fused_linear_cross_entropy as jax_flce
from mojo_opset_tpu.modeling.qwen3 import Qwen3Config as JaxQwen3Config
from mojo_opset_tpu.modeling.qwen3 import Qwen3ForCausalLM as JaxQwen3
from mojo_opset_tpu.modeling.qwen3 import quantize_qwen3 as jax_quantize_qwen3
from mojo_opset_tpu.runtime import GreedySampler as JaxGreedy
from mojo_opset_tpu.runtime import MojoGenerator as JaxGenerator
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
from mojo_opset_tpu_torch.parallel import MojoMesh, qwen3_tp_rules, shard_model
from mojo_opset_tpu_torch.parallel.styles import replace_module, shard_embedding
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state
from tests.torch_parallel_workers import BLOCK, STEPS, spawn

LOSS = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
PARAM = dict(atol=1e-4, rtol=1e-4)
RING = dict(atol=1e-5, rtol=1e-5)
# __graft_entry__.py:18-30 _tiny_config
TINY = dict(hidden_size=128, intermediate_size=256, num_attention_heads=8, num_key_value_heads=4,
            num_hidden_layers=2, head_dim=16, vocab_size=256, max_position_embeddings=512)
KV2 = dict(TINY, num_key_value_heads=2)
TIED = dict(TINY, vocab_size=250, tie_word_embeddings=True)
SPEC = dict(hidden_size=64, intermediate_size=128, num_attention_heads=8, num_key_value_heads=4,
            num_hidden_layers=2, head_dim=16, vocab_size=128, max_position_embeddings=256)
C8 = dict(SPEC, quant_kv=True)
C8_KV2 = dict(C8, num_key_value_heads=2)
OPTIONS = dict(label_smoothing=0.1, lse_square_scale=1e-3)
SCENARIOS = ("train_dp2_tp2", "train_kv_replicated_tp4", "train_tied_uneven_tp4", "train_options_dp2_tp2",
             "speculative_tp4", "c8_tp2", "c8_kv_replicated_tp4", "ring_ops", "dryrun")
MESHES = {"dp2_tp2": {"dp": 2, "tp": 2}, "tp4": {"tp": 4}}


class Tok:
    eos_token_id = -1


def _batch(seed, rows, vocab, length=17):
    batch = np.random.default_rng(seed).integers(0, vocab, (rows, length)).astype(np.int64)
    return batch[:, :-1].copy(), batch[:, 1:].copy()


def _jax_train(cfg, key, ids, targets, loss_kw):
    """JAX's unsharded step on the whole batch: (weights, loss, gradients, weights after optax.adamw(1e-4))."""
    model = JaxQwen3(JaxQwen3Config(**cfg, dtype=jnp.float32), key=jax.random.PRNGKey(key))

    def loss_fn(m):
        hidden = m.train_forward(jnp.asarray(ids, jnp.int32))
        return jax_flce(hidden.reshape(-1, cfg["hidden_size"]), m.lm_head_weight,
                        jnp.asarray(targets, jnp.int32).reshape(-1), **loss_kw)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(model)
    optimizer = optax.adamw(1e-4)
    updates, _ = optimizer.update(grads, optimizer.init(model), model)
    after = optax.apply_updates(model, updates)

    def named(tree):
        return {k: np.asarray(v) for k, v in state_dict_of(tree).items() if not k.endswith("inv_freq")}

    inputs = dict(cfg=cfg, state=dict(state_dict_of(model)), ids=ids, targets=targets, loss_kw=loss_kw)
    return inputs, dict(loss=float(loss), grads=named(grads), params=named(after))


def _jax_stream(model, ids, lens, steps=STEPS):
    """The stepwise greedy stream, each step jitted (as tests/test_torch_quant.py's reference)."""
    gen = JaxGenerator(JaxPaged(model, block_size=BLOCK, jit=True), Tok(), JaxGreedy(), max_new_tokens=steps)
    return np.asarray(gen.generate_from_ids(ids, lens, ignore_eos=True, silent=True))


def _jax_c8(cfg, key, ids, lens):
    model = jax_quantize_qwen3(JaxQwen3(JaxQwen3Config(**cfg, dtype=jnp.float32), key=jax.random.PRNGKey(key)))
    _, session = JaxPaged(model, block_size=BLOCK, jit=False)(ids, context_input_len=lens)
    layers = range(cfg["num_hidden_layers"])
    ref = dict(stream=_jax_stream(model, ids, lens),
               key_scales=[np.asarray(session.caches.key_scale(i)) for i in layers],
               value_scales=[np.asarray(session.caches.value_scale(i)) for i in layers])
    return dict(cfg=cfg, state=dict(state_dict_of(model)), ids=ids, lens=lens), ref


def _jax_speculative():
    """JAX test_parallel_styles.py:259-281's oracle: the unsharded model's stepwise greedy stream."""
    model = JaxQwen3(JaxQwen3Config(**SPEC, dtype=jnp.float32), key=jax.random.PRNGKey(7))
    ids, lens, steps = np.array([1, 2, 3, 4, 5], np.int32), np.array([5], np.int32), 8
    inputs = dict(cfg=SPEC, state=dict(state_dict_of(model)), ids=ids, lens=lens, steps=steps)
    return inputs, _jax_stream(model, ids, lens, steps)[0]


def _ring_case():
    rng = np.random.default_rng(4)
    T, K, N = 16, 32, 12
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((T, K), (N, K), (N,)))
    j = jnp.asarray
    ref = dict(all_gather_gemm=np.asarray(jm.MojoAllGatherGemm(j(w), bias=j(b))(j(x))),
               gemm_reduce_scatter=np.asarray(jm.MojoGemmReduceScatter(j(w), bias=j(b))(j(x))))
    return dict(x=x, w=w, b=b), ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, JAX's references)."""
    inputs, refs = {}, {}
    ids, targets = _batch(0, 4, TINY["vocab_size"])
    inputs["train"], refs["train"] = _jax_train(TINY, 0, ids, targets, {})
    ids, targets = _batch(1, 2, KV2["vocab_size"])
    inputs["train_kv2"], refs["train_kv2"] = _jax_train(KV2, 1, ids, targets, {})
    ids, targets = _batch(2, 2, TIED["vocab_size"])
    inputs["train_tied"], refs["train_tied"] = _jax_train(TIED, 2, ids, targets, {})
    ids, targets = _batch(3, 4, TINY["vocab_size"])
    ignored = np.zeros(targets.shape, bool)
    ignored[0, :3] = True  # dp rank 0 (rows 0-1): 3 of 32 rows ignored
    ignored[2, 5:] = True  # dp rank 1 (rows 2-3): 11 of 32
    targets[ignored] = -100
    inputs["train_options"], refs["train_options"] = _jax_train(TINY, 3, ids, targets, OPTIONS)
    inputs["speculative"], refs["speculative"] = _jax_speculative()
    lens = np.array([9, 4], np.int32)
    prompt = np.random.default_rng(5).integers(1, SPEC["vocab_size"], int(lens.sum())).astype(np.int32)
    inputs["c8"], refs["c8"] = _jax_c8(C8, 7, prompt, lens)
    inputs["c8_kv2"], refs["c8_kv2"] = _jax_c8(C8_KV2, 8, prompt, lens)
    inputs["ring"], refs["ring"] = _ring_case()
    return spawn(tmp_path_factory.mktemp("train"), 4, SCENARIOS, inputs), refs, inputs


def ranks(runs, scenario):
    """Each rank's result of ``scenario``; a scenario that raised on a rank fails here with its traceback."""
    out = [r[scenario] for r in runs[0]]
    for rank, o in enumerate(out):
        if isinstance(o, dict) and "error" in o:
            pytest.fail(f"rank {rank}: {o['error']}")
    return out


def _shard_of(cfg, arrays, state, coords, split_embedding=False) -> dict:
    """``arrays`` (JAX's gradients or weights, by name) cut as the rank at ``coords`` holds its parameters."""
    model = Qwen3ForCausalLM(Qwen3Config(**cfg, dtype=torch.float32), device="cpu")
    load_numpy_state(model, {**state, **arrays})
    shape = next(s for s in MESHES.values() if set(s) == set(coords))
    mesh = MojoMesh.local(shape, coords)
    shard_model(model, mesh, qwen3_tp_rules("tp"))
    if split_embedding:
        replace_module(model, "model.embed_tokens", shard_embedding(model.model.embed_tokens, mesh.size("tp"),
                                                                    mesh.rank("tp"), None))
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


TRAIN_CASES = {"train_dp2_tp2": ("train", False), "train_kv_replicated_tp4": ("train_kv2", False),
               "train_tied_uneven_tp4": ("train_tied", True), "train_options_dp2_tp2": ("train_options", False)}


@pytest.mark.parametrize("scenario", list(TRAIN_CASES))
def test_train_step_loss_matches_jax(runs, scenario):
    want = runs[1][TRAIN_CASES[scenario][0]]["loss"]
    for out in ranks(runs, scenario):
        check_tol_diff(np.float32(out["loss"]), np.float32(want), **LOSS)
        assert out["golden"] == 0  # the loss ran on kernel N's plain version, not the golden


@pytest.mark.parametrize("what", ["grads", "params"])
@pytest.mark.parametrize("scenario", list(TRAIN_CASES))
def test_train_step_every_gradient_and_parameter_match_jax(runs, scenario, what):
    """Each rank's gradient of every parameter (after ``finish_gradients``),
    and every parameter after the AdamW step, against the same shard of JAX's."""
    key, split = TRAIN_CASES[scenario]
    inp, want = runs[2][key], runs[1][key][what]
    tol = GRAD if what == "grads" else PARAM
    for out in ranks(runs, scenario):
        expect = _shard_of(inp["cfg"], want, inp["state"], out["coords"], split)
        assert set(out[what]) == set(expect)
        for name, got in out[what].items():
            assert got.shape == expect[name].shape, name
            check_tol_diff(got, expect[name], **tol)


def test_train_step_is_vocab_parallel(runs):
    """The loss read the rank's LM-head rows: an owned head's even split, a tied head's ceil split (63, 63, 63, 61
    rows of 250), with the vocabulary's size beside them."""
    assert [o["vocab"] for o in ranks(runs, "train_dp2_tp2")] == [(0, 256), (128, 256)] * 2
    assert [o["vocab"] for o in ranks(runs, "train_tied_uneven_tp4")] == [(0, 250), (63, 250), (126, 250),
                                                                           (189, 250)]
    rows = [o["grads"]["model.embed_tokens.weight"].shape[0] for o in ranks(runs, "train_tied_uneven_tp4")]
    assert rows == [63] * 4
    assert not ranks(runs, "train_tied_uneven_tp4")[3]["grads"]["model.embed_tokens.weight"][61:].any()


def test_kv_replicated_gradients_agree_between_holders(runs):
    """tp 4 with 2 kv heads: ranks 0-1 hold kv head 0, ranks 2-3 kv head 1; each pair holds one gradient of the
    head's k_proj and v_proj rows, and every rank one k_norm gradient."""
    outs = ranks(runs, "train_kv_replicated_tp4")
    for layer in range(KV2["num_hidden_layers"]):
        p = f"model.layers.{layer}.self_attn."
        for a, b in ((0, 1), (2, 3)):
            for name in ("k_proj.weight", "v_proj.weight"):
                np.testing.assert_array_equal(outs[a]["grads"][p + name], outs[b]["grads"][p + name])
        for o in outs[1:]:
            np.testing.assert_array_equal(o["grads"][p + "k_norm.weight"], outs[0]["grads"][p + "k_norm.weight"])
            np.testing.assert_array_equal(o["grads"][p + "q_norm.weight"], outs[0]["grads"][p + "q_norm.weight"])


def test_speculative_tp4_matches_jax_greedy(runs):
    want = runs[1]["speculative"]
    for out in ranks(runs, "speculative_tp4"):
        np.testing.assert_array_equal(out["tokens"][0], want)
        assert out["draft"] == "CudaQuantGemm" and out["draft_rows"] == (32, 64)  # 2 of 8 heads x 16, int8 (N, K)
        assert out["rounds"] > 0


@pytest.mark.parametrize("scenario, key, heads", [("c8_tp2", "c8", [[0, 1], [2, 3]] * 2),
                                                   ("c8_kv_replicated_tp4", "c8_kv2", [[0], [0], [1], [1]])])
def test_c8_cache_under_tp_matches_jax(runs, scenario, key, heads):
    """Tokens equal JAX's unsharded w8a8 + C8 stepwise stream; each rank calibrated the scales of its kv heads
    alone, equal to the unsharded session's rows for those heads (ranks that share a head: the same scales)."""
    ref = runs[1][key]
    for out, kv in zip(ranks(runs, scenario), heads):
        np.testing.assert_array_equal(out["tokens"], ref["stream"])
        assert out["kv_heads"] == len(kv) and out["cache"][1] == len(kv)  # HND: (blocks, Hkv, bs, D)
        for mine, want in zip(out["key_scales"] + out["value_scales"], ref["key_scales"] + ref["value_scales"]):
            check_tol_diff(mine, want[kv], atol=0.0, rtol=1e-6)


@pytest.mark.parametrize("world", [4, 2])
def test_ring_compute_comm_ops_match_jax(runs, world):
    ref = runs[1]["ring"]
    for rank, out in enumerate(ranks(runs, "ring_ops")):
        got = out[world]
        n, r = world, rank % world
        assert got["tiers"] == ("CudaAllGatherGemm", "CudaGemmReduceScatter")
        check_tol_diff(got["all_gather_gemm"], ref["all_gather_gemm"], **RING)
        check_tol_diff(got["gemm_reduce_scatter"], np.split(ref["gemm_reduce_scatter"], n, axis=0)[r], **RING)


def test_ring_gather_dim_1_takes_the_golden(runs):
    for out in ranks(runs, "ring_ops"):
        check_tol_diff(out["gather_dim1"], runs[1]["ring"]["all_gather_gemm"], **RING)


def test_dryrun_step_trains_and_serves_on_the_mesh(runs):
    """``dryrun_step`` on dp 2 x tp 2: one finite loss, the same on every rank, and the sharded model's 4 fused
    decode steps after its paged prefill, the same tokens on every rank."""
    outs = ranks(runs, "dryrun")
    assert all(np.isfinite(o["loss"]) and o["loss"] == outs[0]["loss"] for o in outs)
    assert all(o["mesh"] == (2, 2) for o in outs)
    for o in outs:
        assert o["tokens"].shape == (4, 2)  # (steps, sequences)
        np.testing.assert_array_equal(o["tokens"], outs[0]["tokens"])


def test_dryrun_multichip_spawns_its_ranks():
    """JAX's ``dryrun_multichip(n)`` form: two processes (dp 2 x tp 1), one step each, then prefill and decode."""
    repo = Path(__file__).resolve().parents[1]
    code = ("from mojo_opset_tpu_torch.parallel.training import dryrun_multichip; "
            "out = dryrun_multichip(2, device='cpu'); "
            "assert len({float(o['loss']) for o in out}) == 1 and all(o['tokens'].shape == (4, 2) for o in out)")
    run = subprocess.run([sys.executable, "-c", code], cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
                         capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert run.stdout.count("dryrun_multichip(n=2)") == 2 and "mesh=(2x1)" in run.stdout


@pytest.mark.parametrize("rank", [0, 1])
def test_row_parallel_bias_trains_on_rank_0_only(rank):
    """A row-parallel projection's bias is added once, by rank 0; the other ranks hold zeros, which keep their
    gradient flag (a shard keeps its parameter's) and so must be recorded: their gradient is zeroed."""
    import mojo_opset_tpu_torch as tm
    from mojo_opset_tpu_torch.parallel.styles import rowwise
    from mojo_opset_tpu_torch.parallel.training import sum_partial_gradients

    op = tm.MojoGemm(8, 4, bias=True, device="cpu").requires_grad_(True)
    rowwise(op, 2, rank, None)
    assert op.weight.requires_grad and op.bias.requires_grad and op.weight.shape == (4, 4)
    assert [r[:2] for r in op.__dict__.get("mojo_partial_grads", [])] == ([] if rank == 0 else [("bias", "zero")])
    op(torch.ones(3, 4)).sum().backward()
    sum_partial_gradients(op)
    assert bool(op.bias.grad.any()) == (rank == 0)
