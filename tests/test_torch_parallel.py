"""Port parity for the distributed layer, dense Qwen3: tensor parallelism on
torch.distributed against the unsharded JAX model, on the CPU.

One spawn of four gloo rank processes (``tests/torch_parallel_workers.py``,
``file://`` init) runs every multi-rank check: Qwen3 at tp 4 (JAX
tests/distributed/test_tp_decode_parity.py:24-27's config), at tp 2 (the tp
axis of a 2 x 2 dp x tp mesh), through the styles plan of JAX
test_parallel_styles.py:16, with 2 kv heads at tp 4 (:52, each rank keeps
the kv head its queries read), in w8a8 at tp 2 (:217); the six
compute+comm ops at world 2; the vocab-parallel embedding; the per-rank
checkpoint; the AFD meshes; a graph asked for over gloo. The weights come
from JAX's tiny models (``load_numpy_state``), and the reference is the
unsharded JAX model in this process on its stepwise, unjitted stream
(ROADMAP.md, queue 3, PR 5). Tokens must be equal on every rank and equal
to JAX's; fp32 logits and op outputs hold to atol = rtol = 1e-4 (BASELINE.md's
fp32 ladder: 6e-3 max), since the row-parallel sums run in another order.

In-process checks (no spawn): each style's rank slices against ``np.split``
of the JAX parameter along the axis of the JAX style's own PartitionSpec,
the head plan, the style registry (JAX :160), the configs and the comm
context (JAX tests/distributed/test_comm_context.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import mojo_opset_tpu as jm
import mojo_opset_tpu.parallel as jp
import mojo_opset_tpu_torch as tm
from mojo_opset_tpu.modeling.qwen3 import Qwen3Config as JaxQwen3Config
from mojo_opset_tpu.modeling.qwen3 import Qwen3ForCausalLM as JaxQwen3
from mojo_opset_tpu.modeling.qwen3 import quantize_qwen3 as jax_quantize_qwen3
from mojo_opset_tpu.runtime import GreedySampler as JaxGreedy
from mojo_opset_tpu.runtime import MojoGenerator as JaxGenerator
from mojo_opset_tpu.runtime import PagedAttentionGenerationModel as JaxPaged
from mojo_opset_tpu.utils.hf import state_dict_of
from mojo_opset_tpu_torch import parallel as tp
from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
from mojo_opset_tpu_torch.runtime import MojoParallelConfig, comm_context
from mojo_opset_tpu_torch.utils.acc import check_tol_diff
from mojo_opset_tpu_torch.utils.weights import load_numpy_state
from tests.torch_parallel_workers import BLOCK, STEPS, spawn

F32 = dict(atol=1e-4, rtol=1e-4)
TP_CFG = dict(hidden_size=64, intermediate_size=128, num_attention_heads=8, num_key_value_heads=4,
              num_hidden_layers=2, head_dim=16, vocab_size=256, max_position_embeddings=128)
KV2_CFG = dict(TP_CFG, num_key_value_heads=2)
W8A8_CFG = dict(TP_CFG, vocab_size=128)
CB_STEPS = 5
SCENARIOS = ("dense_tp4", "dense_tp2", "styles_plan_tp4", "kv_replicated_tp4", "w8a8_tp2", "graph_over_gloo",
             "comm_ops", "parallel_embedding", "checkpoint_roundtrip", "afd_meshes")


class Tok:
    eos_token_id = -1


def _jax_stream(model, ids, lens, steps=STEPS):
    gen = JaxGenerator(JaxPaged(model, block_size=BLOCK, jit=False), Tok(), JaxGreedy(), max_new_tokens=steps)
    return np.asarray(gen.generate_from_ids(ids, lens, ignore_eos=True, silent=True))


def _jax_case(cfg, key, ids, lens, quant=False):
    model = JaxQwen3(JaxQwen3Config(**cfg, dtype=jnp.float32), key=jax.random.PRNGKey(key))
    if quant:
        model = jax_quantize_qwen3(model)
    logits, _ = JaxPaged(model, block_size=BLOCK, jit=False)(ids, context_input_len=lens)
    return model, dict(cfg=cfg, state=dict(state_dict_of(model)), ids=ids, lens=lens), dict(
        stream=_jax_stream(model, ids, lens), logits=np.asarray(logits))


def _ops_inputs():
    rng = np.random.default_rng(3)
    T, K, N = 16, 32, 12
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((T, K), (N, K), (N,)))
    M, Kq, Nq = 8, 16, 64
    quant = dict(x=rng.integers(-100, 100, (M, Kq)).astype(np.int8), w=rng.integers(-100, 100, (Nq, Kq)).astype(np.int8),
                 ws=(np.abs(rng.standard_normal(Nq)) + 0.1).astype(np.float32),
                 ts=(np.abs(rng.standard_normal(M)) + 0.1).astype(np.float32))
    return dict(x=x, w=w, b=b, quant=quant)


def _ops_golden(o):
    """The six ops' unsharded JAX goldens (``axis_name=None``)."""
    j = lambda a: jnp.asarray(a)  # noqa: E731
    q = o["quant"]
    return dict(
        gemm_all_reduce=jm.MojoGemmAllReduce(j(o["w"]), bias=j(o["b"]))(j(o["x"])),
        all_gather_gemm=jm.MojoAllGatherGemm(j(o["w"]))(j(o["x"])),
        gemm_reduce_scatter=jm.MojoGemmReduceScatter(j(o["w"]))(j(o["x"])),
        gemm_all2all=jm.MojoGemmAll2All(j(o["w"]), scatter_dim=1, gather_dim=0)(j(o["x"])),
        quant_gemm_all2all=jm.MojoQuantGemmAll2All(j(q["w"]), j(q["ws"]), output_dtype=jnp.float32)(
            j(q["x"]), j(q["ts"])),
        all2all_quant_gemm=jm.MojoAll2AllQuantGemm(j(q["w"]), j(q["ws"]), output_dtype=jnp.float32)(
            j(q["x"]), j(q["ts"])),
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, JAX's references, the inputs)."""
    rng = np.random.default_rng(11)
    lens = np.array([9, 4], np.int32)
    ids = rng.integers(1, 256, int(lens.sum())).astype(np.int32)
    prompts = [np.random.default_rng(7).integers(1, 256, n).astype(np.int32) for n in (5, 9, 3)]
    dense_model, dense, dense_ref = _jax_case(TP_CFG, 3, ids, lens)
    dense.update(prompts=prompts, cb_steps=CB_STEPS)
    dense_ref["continuous"] = [_jax_stream(dense_model, p, np.array([len(p)], np.int32), CB_STEPS)[0]
                               for p in prompts]
    _, kv2, kv2_ref = _jax_case(KV2_CFG, 3, ids, lens)
    _, w8a8, w8a8_ref = _jax_case(W8A8_CFG, 7, np.array([1, 2, 3, 4, 5, 9, 8], np.int32), np.array([5, 2], np.int32),
                                  quant=True)
    table = np.random.default_rng(5).standard_normal((10, 8)).astype(np.float32)
    embedding = dict(table=table, ids=np.array([[0, 3, 9, 4], [7, 7, 1, 2]], np.int64),
                     hidden=np.random.default_rng(6).standard_normal((3, 8)).astype(np.float32))
    inputs = dict(dense=dense, kv2=kv2, w8a8=w8a8, ops=_ops_inputs(), embedding=embedding)
    refs = dict(dense=dense_ref, kv2=kv2_ref, w8a8=w8a8_ref, ops=_ops_golden(inputs["ops"]))
    results = spawn(tmp_path_factory.mktemp("tp"), 4, SCENARIOS, inputs)
    return results, refs, inputs


def ranks(runs, scenario):
    """Each rank's result of ``scenario``; a scenario that raised on a rank fails here with its traceback."""
    out = [r[scenario] for r in runs[0]]
    for rank, o in enumerate(out):
        if isinstance(o, dict) and "error" in o:
            pytest.fail(f"rank {rank}: {o['error']}")
    return out


# ---------------------------------------------------------------- dense Qwen3 under tensor parallelism


@pytest.mark.parametrize("scenario", ["dense_tp4", "dense_tp2", "styles_plan_tp4"])
@pytest.mark.parametrize("stream", ["stepwise", "fused"])
def test_tp_greedy_tokens_match_jax(runs, scenario, stream):
    want = runs[1]["dense"]["stream"]
    for out in ranks(runs, scenario):
        np.testing.assert_array_equal(out[stream], want)


@pytest.mark.parametrize("scenario", ["dense_tp4", "dense_tp2", "styles_plan_tp4"])
def test_tp_prefill_logits_match_jax(runs, scenario):
    want = runs[1]["dense"]["logits"]
    outs = ranks(runs, scenario)
    for out in outs:
        check_tol_diff(out["logits"], want, **F32)
        np.testing.assert_array_equal(out["logits"], outs[0]["logits"])  # every rank holds the same logits


@pytest.mark.parametrize("scenario,tp", [("dense_tp4", 4), ("dense_tp2", 2)])
def test_tp_continuous_batching_matches_jax(runs, scenario, tp):
    for out in ranks(runs, scenario):
        for got, want in zip(out["continuous"], runs[1]["dense"]["continuous"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scenario,tp", [("dense_tp4", 4), ("dense_tp2", 2)])
def test_tp_session_holds_the_rank_kv_heads(runs, scenario, tp):
    kv = TP_CFG["num_key_value_heads"] // tp
    for out in ranks(runs, scenario):
        assert out["tp"] == tp and out["local_num_kv_heads"] == kv == out["kv_heads"]
        assert out["cache_shape"][2] == kv  # NHD pages: (blocks, block, kv heads, head_dim)
    assert ranks(runs, "dense_tp4")[0]["q_rows"] == (TP_CFG["num_attention_heads"] // 4 * TP_CFG["head_dim"],
                                                    TP_CFG["hidden_size"])


@pytest.mark.parametrize("stream", ["stepwise", "fused"])
def test_kv_replicated_tp4_tokens_match_jax(runs, stream):
    """tp 4 over 2 kv heads: JAX replicates k/v; each port rank keeps the kv head its two query heads read."""
    for out in ranks(runs, "kv_replicated_tp4"):
        np.testing.assert_array_equal(out[stream], runs[1]["kv2"]["stream"])
        check_tol_diff(out["logits"], runs[1]["kv2"]["logits"], **F32)


def test_kv_replicated_tp4_keeps_the_kv_head_of_its_queries(runs):
    k_full = runs[2]["kv2"]["state"]["model.layers.0.self_attn.k_proj.weight"]
    D = KV2_CFG["head_dim"]
    for rank, out in enumerate(ranks(runs, "kv_replicated_tp4")):
        assert out["heads"] == (2, 1) and out["local_num_kv_heads"] == 1 == out["kv_heads"]
        kv_head = rank // 2  # AABB: query heads 2r, 2r + 1 of 8 read kv head (2r) // 4
        np.testing.assert_array_equal(out["k_proj"], k_full[kv_head * D:(kv_head + 1) * D])


@pytest.mark.parametrize("stream", ["stepwise", "fused"])
def test_w8a8_tp2_tokens_match_jax(runs, stream):
    """w8a8 at tp 2: the dynamic quant before o_proj and down_proj takes the whole row's amax (all_reduce MAX)."""
    for out in ranks(runs, "w8a8_tp2"):
        np.testing.assert_array_equal(out[stream], runs[1]["w8a8"]["stream"])
        check_tol_diff(out["logits"], runs[1]["w8a8"]["logits"], **F32)


def test_w8a8_tp2_scales_follow_their_weights(runs):
    state = runs[2]["w8a8"]["state"]
    q_scale, o_scale = (state[f"model.layers.0.self_attn.{p}.weight_scale"] for p in ("q_proj", "o_proj"))
    for out in ranks(runs, "w8a8_tp2"):
        assert out["q_scale"].shape == (q_scale.shape[0] // 2,)
        np.testing.assert_array_equal(out["o_scale"], o_scale)  # the row-parallel scale stays whole
    np.testing.assert_array_equal(np.concatenate([o["q_scale"] for o in ranks(runs, "w8a8_tp2")[:2]]), q_scale)


def test_graph_over_gloo_raises(runs):
    for out in ranks(runs, "graph_over_gloo"):
        assert all(e is not None and "gloo" in e for e in out["errors"]), out["errors"]
        assert out["eager_graph"] is False


# ---------------------------------------------------------------- ops, embedding, checkpoint, meshes


def _reassemble(name, outs, n, ref):
    """The full result from the ranks' outputs (``outs`` of one tp group, in rank order)."""
    if name in ("gemm_all_reduce", "all_gather_gemm"):
        for o in outs:
            check_tol_diff(o, ref, **F32)
        return outs[0]
    if name in ("gemm_reduce_scatter", "all2all_quant_gemm"):
        return np.concatenate(outs, axis=0)
    if name == "gemm_all2all":
        return np.concatenate(outs, axis=1)
    M, N = ref.shape  # quant_gemm_all2all: rank r's block p = peer p's column sub-chunk r
    nl, nsub = N // n, N // n // n
    full = np.zeros((M, N), np.float32)
    for r, o in enumerate(outs):
        for p in range(n):
            full[:, p * nl + r * nsub:p * nl + (r + 1) * nsub] = o[p * M:(p + 1) * M]
    return full


@pytest.mark.parametrize("name", ["gemm_all_reduce", "all_gather_gemm", "gemm_reduce_scatter", "gemm_all2all",
                                  "quant_gemm_all2all", "all2all_quant_gemm"])
def test_compute_comm_ops_match_jax_golden(runs, name):
    outs = ranks(runs, "comm_ops")
    ref = np.asarray(runs[1]["ops"][name])
    for group in ((0, 1), (2, 3)):  # the two tp groups of the 2 x 2 (dp, tp) mesh
        check_tol_diff(_reassemble(name, [outs[r][name] for r in group], 2, ref), ref, **F32)


@pytest.mark.parametrize("mesh,n", [("tp4", 4), ("tp2", 2)])
def test_parallel_embedding_matches_unsharded_lookup(runs, mesh, n):
    e = runs[2]["embedding"]
    for out in ranks(runs, "parallel_embedding"):
        got = out[mesh]
        assert got["rows"] == -(-10 // n)  # ceil(V / n); tp 4 leaves the last shard one row of 3
        np.testing.assert_array_equal(got["lookup"], e["table"][e["ids"]])
        check_tol_diff(got["logits"], e["hidden"] @ e["table"].T, **F32)


def test_checkpoint_roundtrip(runs):
    for out in ranks(runs, "checkpoint_roundtrip"):
        assert out["equal"]
        assert out["name"].startswith("a.weight@dp") and ",tp" in out["name"]
        assert out["missing"] is not None and "missing keys" in out["missing"]  # the keys carry the coordinates


def test_afd_meshes_and_dp_exchange(runs):
    outs = ranks(runs, "afd_meshes")
    for rank, out in enumerate(outs):
        if rank < 2:
            assert out["attn"] == ({"pp": 1, "dp": 2, "sp": 1, "tp": 1}, {"pp": 0, "dp": rank, "sp": 0, "tp": 0})
            assert out["ffn"] is None and out["role"] == out["attn"][1]
        else:
            assert out["attn"] is None and out["role"] is None
            assert out["ffn"] == ({"pp": 1, "ep": 2, "tp": 1}, {"pp": 0, "ep": rank - 2, "tp": 0})
        # gather the dp group's tokens, the shared FFN (x 3), reduce-scatter back: each dp rank sums 2 copies
        np.testing.assert_array_equal(out["merged"], 6 * out["x"])
    for group in ((0, 2), (1, 3)):  # the dp groups of the (dp, tp) mesh
        np.testing.assert_array_equal(outs[group[0]]["summed"], outs[group[0]]["x"] + outs[group[1]]["x"])


# ---------------------------------------------------------------- in-process: styles against JAX's specs


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.array(jax.devices()[:4]), ("tp",))


def _port_model(cfg, key):
    jax_model = JaxQwen3(JaxQwen3Config(**cfg, dtype=jnp.float32), key=jax.random.PRNGKey(key))
    state = dict(state_dict_of(jax_model))
    return lambda: load_numpy_state(Qwen3ForCausalLM(Qwen3Config(**cfg, dtype=torch.float32), device="cpu"), state), \
        state


def _expect(jax_style, name, full, jax_mesh, rank):
    spec = jax_style.spec_for("." + name, jnp.asarray(full), jax_mesh)
    axes = [d for d, a in enumerate(spec) if a == "tp"]
    return np.split(full, 4, axis=axes[0])[rank] if axes else full


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("case", ["colwise", "rowwise", "qkv", "tensor_mlp", "swiglu", "experts"])
def test_style_slices_match_jax_partition_specs(case, rank, jax_mesh):
    mesh = tp.MojoMesh.local({"tp": 4, "ep": 4}, {"tp": rank, "ep": rank})
    build, state = _port_model(TP_CFG, 3)
    if case in ("colwise", "rowwise", "qkv", "tensor_mlp"):
        model = build()
        prefix = "model.layers.0." + ("self_attn" if case in ("colwise", "rowwise", "qkv") else "mlp")
        module = model.get_submodule(prefix)
        if case == "colwise":
            module = module.q_proj
            prefix += ".q_proj"
            styles = (tp.MojoColwiseParallel(), jp.MojoColwiseParallel())
        elif case == "rowwise":
            module = module.o_proj
            prefix += ".o_proj"
            styles = (tp.MojoRowwiseParallel(), jp.MojoRowwiseParallel())
        elif case == "qkv":
            styles = (tp.MojoQKVColwiseParallel(8, 4), jp.MojoQKVColwiseParallel(8, 4))
        else:
            styles = (tp.MojoTensorParallel(), jp.MojoTensorParallel())
        styles[0].apply(module, mesh)
        for name, got in module.named_parameters():
            full = state[f"{prefix}.{name}"]
            if case == "qkv" and name.startswith("o_proj"):  # JAX leaves o_proj whole for GSPMD; the port
                want = np.split(full, 4, axis=1)[rank]     # row-splits it over the rank's heads
            else:
                want = _expect(styles[1], name, full, jax_mesh, rank)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        return
    if case == "swiglu":
        g = torch.Generator().manual_seed(0)
        module = tm.MojoSwiGLUMLP(16, 16, 32, device="cpu", generator=g)
        fc1, fc2 = module.fc1.weight.numpy().copy(), module.fc2.weight.numpy().copy()
        tp.MojoSwiGLUParallel().apply(module, mesh)
        spec = jp.MojoSwiGLUParallel().spec_for(".fc1.weight", jnp.asarray(fc1), jax_mesh)
        halves = [np.split(h, 4, axis=spec.index("tp"))[rank] for h in np.split(fc1, 2, axis=0)]  # each half alone
        np.testing.assert_array_equal(module.fc1.weight.numpy(), np.concatenate(halves))
        np.testing.assert_array_equal(module.fc2.weight.numpy(),
                                      _expect(jp.MojoSwiGLUParallel(), "fc2.weight", fc2, jax_mesh, rank))
        return
    module = tm.MojoQuantMoE(8, 2, 32, 16, device="cpu")
    g = torch.Generator().manual_seed(1)
    full = {n: (p.normal_(generator=g) if p.is_floating_point() else p.random_(-100, 100, generator=g)).numpy().copy()
            for n, p in module.named_parameters()}
    tp.MojoExpertParallel().apply(module, mesh)
    jax_mesh_ep = Mesh(np.array(jax.devices()[:4]), ("ep",))
    for name, got in module.named_parameters():
        spec = jp.MojoExpertParallel().spec_for("." + name, jnp.asarray(full[name]), jax_mesh_ep)
        want = np.split(full[name], 4, axis=0)[rank] if "ep" in tuple(spec) else full[name]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("layout", ["AABB", "ABAB"])
@pytest.mark.parametrize("heads,kv,size", [(8, 4, 1), (8, 4, 2), (8, 4, 4), (8, 2, 4), (8, 2, 8), (16, 4, 8)])
def test_head_plan_pairs_each_query_head_with_its_kv_head(layout, heads, kv, size):
    """Every query head lands on one rank, beside the kv head it reads under
    the layout, at the local index the layout gives it there."""
    seen = []
    for rank in range(size):
        q, k = tp.head_plan(heads, kv, size, rank, layout)
        seen += q
        for j, h in enumerate(q):
            want_kv = h // (heads // kv) if layout == "AABB" else h % kv
            local = j // (len(q) // len(k)) if layout == "AABB" else j % len(k)
            assert k[local] == want_kv, (rank, h)
    assert sorted(seen) == list(range(heads))


def test_head_plan_refuses_heads_that_do_not_split():
    with pytest.raises(ValueError, match="do not split"):
        tp.head_plan(8, 4, 3, 0)
    with pytest.raises(ValueError, match="do not split"):
        tp.head_plan(8, 2, 6, 0)


def test_shard_model_replicates_what_does_not_divide(caplog):
    """A spec whose axis does not divide the dimension falls back to whole
    weights with a warning (JAX plans.py:56-70): at tp 3 nothing of the tiny
    model splits, and its logits equal the unsharded model's."""
    build, _ = _port_model(TP_CFG, 3)
    whole, sharded = build(), build()
    tp.shard_model(sharded, tp.MojoMesh.local({"tp": 3}, {"tp": 1}), tp.qwen3_tp_rules())
    assert sharded.model.layers[0].self_attn.num_heads == 8
    assert not isinstance(sharded.model.embed_tokens, tm.MojoParallelEmbedding)
    ids, lens = np.arange(1, 8, dtype=np.int32), np.array([7], np.int32)
    from mojo_opset_tpu_torch.runtime import PagedAttentionGenerationModel

    a, _ = PagedAttentionGenerationModel(whole, block_size=BLOCK)(ids, context_input_len=lens)
    b, _ = PagedAttentionGenerationModel(sharded, block_size=BLOCK)(ids, context_input_len=lens)
    assert torch.equal(a, b)


def test_sharded_config_reports_the_rank_view():
    build, _ = _port_model(TP_CFG, 3)
    model = tp.shard_model(build(), tp.MojoMesh.local({"tp": 4}, {"tp": 2}), tp.qwen3_tp_rules())
    cfg = model.config
    assert cfg.model_config.num_kv_heads == 4 and cfg.model_config.local_num_kv_heads == 1
    assert cfg.parallel_config.ATTN_TP_SIZE == 4 and cfg.parallel_config.world_size == 4
    assert isinstance(model.model.embed_tokens, tm.MojoParallelEmbedding)
    assert model.model.embed_tokens.vocab_start == 2 * 64
    assert build().config.model_config.local_num_kv_heads == 4  # an unsharded model: every kv head


def test_shard_model_refuses_rules_no_style_takes():
    build, _ = _port_model(TP_CFG, 3)
    with pytest.raises(NotImplementedError, match="no style takes"):
        tp.shard_model(build(), tp.MojoMesh.local({"tp": 2}, {"tp": 0}),
                       [tp.ShardRule("*input_layernorm.weight", ("tp",))])


def test_registerable_style_registry_and_apply():
    """register_dist_info is keyed by module class, each subclass has its
    own registry, and apply partitions through the registered function and
    wraps the forward (JAX test_parallel_styles.py:160)."""
    class MyStyle(tp.MojoRegisterableParallelStyle):
        pass

    class OtherStyle(tp.MojoRegisterableParallelStyle):
        pass

    calls = {}

    def partition_fn(module, mesh):
        calls["partition"] = True
        return module

    MyStyle.register_dist_info(tm.MojoGemm, partition_fn=partition_fn, desired_input_layouts=(),
                               desired_output_layouts=())
    assert OtherStyle.get_dist_info(tm.MojoGemm) is None and MyStyle.get_dist_info(tm.MojoGemm) is not None
    gemm = tm.MojoGemm(8, 8, bias=False, device="cpu")
    x = torch.ones((4, 8))
    want = gemm(x)
    wrapped = MyStyle().apply(gemm, tp.MojoMesh.local({"tp": 2}, {"tp": 0}))
    assert calls["partition"]
    assert torch.equal(wrapped(x), want)
    # a desired input layout sharded on dim 1 cuts a replicated input to the rank's block
    ColStyle = type("ColStyle", (tp.MojoRegisterableParallelStyle,), {})
    ColStyle.register_dist_info(tm.MojoGemm, partition_fn=lambda m, mesh: tp.MojoRowwiseParallel().apply(m, mesh),
                                desired_input_layouts=(None, "tp"))
    row = ColStyle().apply(tm.MojoGemm(8, 8, bias=False, device="cpu"), tp.MojoMesh.local({"tp": 2}, {"tp": 1}))
    assert row.module.weight.shape == (8, 4)
    assert torch.equal(row(torch.arange(16.0).reshape(2, 8)), torch.arange(16.0).reshape(2, 8)[:, 4:] @ row.module.weight.t())


def test_distributed_module_tracks_managed_params():
    build, _ = _port_model(TP_CFG, 3)
    model = build()
    wrapped = tp.MojoDistributedModule(model.model.layers[0].mlp, tp.MojoTensorParallel())
    unmanaged = wrapped.get_unmanaged_params(model)
    assert "model.layers.0.mlp.gate_proj.weight" not in unmanaged
    assert "model.layers.0.self_attn.q_proj.weight" in unmanaged


def test_parallel_config_sizes():
    c = MojoParallelConfig(ATTN_DP_SIZE=2, ATTN_TP_SIZE=4)
    assert c.world_size == 8
    with pytest.raises(ValueError, match="AFD is disabled"):
        c.attn_world_size
    afd = MojoParallelConfig(AFD_ENABLED=True, ATTN_DP_SIZE=2, FFN_EP_SIZE=4)
    assert (afd.attn_world_size, afd.ffn_world_size, afd.world_size) == (2, 4, 6)
    with pytest.raises(ValueError, match="positive"):
        MojoParallelConfig(ATTN_TP_SIZE=0)
    assert Qwen3Config(**TP_CFG).to_mojo().parallel_config == MojoParallelConfig()


def test_comm_context_caches_ops_workspaces_and_managers():
    comm_context.MojoSymmetricMemoryManager._instances.clear()
    a = comm_context.MojoSymmetricMemoryManager.get(device="cpu")
    assert a is comm_context.MojoSymmetricMemoryManager.get(device="cpu") and a.group is None
    buf = a.create_tensor((4, 8), torch.bfloat16)
    assert buf.shape == (4, 8) and buf.dtype == torch.bfloat16 and a.team_split_strided(2) is None
    ctx = comm_context.MojoComputeCommContext(device="cpu")
    w, ws = torch.zeros((8, 4), dtype=torch.int8), torch.ones(8)
    op1 = ctx.get_op(tm.MojoQuantGemmAll2All, w, weight_scale=ws)
    assert op1 is ctx.get_op(tm.MojoQuantGemmAll2All, w, weight_scale=ws)
    assert op1 is not ctx.get_op(tm.MojoQuantGemmAll2All, w, weight_scale=torch.ones(8))
    assert op1 is not ctx.get_op(tm.MojoAll2AllQuantGemm, w, weight_scale=ws)
    wk = ctx.get_workspace("a2a", (16, 4), torch.bfloat16)
    assert wk is ctx.get_workspace("a2a", (16, 4), torch.bfloat16)
    assert wk is not ctx.get_workspace("a2a", (32, 4), torch.bfloat16)


def test_collectives_without_a_group_are_identities():
    x = torch.arange(12.0).reshape(3, 4)
    for out in (comm_context.all_reduce(x, None), comm_context.all_gather(x, None, 1),
                comm_context.reduce_scatter(x, None, 0), comm_context.all_to_all(x, None, 0, 1)):
        assert out is x
    assert comm_context.model_groups(torch.nn.Linear(2, 2)) == []
