"""Rank processes of the port's distributed CPU tests.

``spawn`` starts ``world`` processes of ``python -m tests.torch_parallel_workers``
that join one gloo world through a ``file://`` init, build the meshes every
scenario uses, run the named scenarios on the inputs the test wrote (numpy
weights and prompts) and write what each rank computed; the test holds
those results to the JAX package's, computed in its own process. The ranks
import torch and the port only. One spawn runs many scenarios: a scenario
that raises on a rank records its traceback there, and the test that reads
it fails.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
STEPS = 8
BLOCK = 16


def spawn(workdir, world: int, scenarios, inputs: dict, timeout: int = 600) -> list:
    """Run ``scenarios`` on ``world`` ranks; returns each rank's ``{scenario: result}``."""
    workdir = Path(workdir)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(dict(inputs, scenarios=list(scenarios)), f)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("MOJO_BACKEND", None)
    # each rank writes to files of its own: a rank blocked on a full pipe
    # would hold every other rank at its next collective
    logs = [open(workdir / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_workers", str(r), str(world),
                               str(workdir)], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
             for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            p.kill()
    errs = []
    for log in logs:
        log.seek(0)
        errs.append(log.read()[-4000:])
        log.close()
    failed = [(r, p.returncode, err) for r, (p, err) in enumerate(zip(procs, errs)) if p.returncode]
    if failed:
        raise AssertionError(f"rank processes failed: {failed}")
    results = []
    for r in range(world):
        with open(workdir / f"out_{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------- helpers run in the ranks


def _torch():
    import torch

    return torch


def _qwen3(cfg: dict, state: dict, quant=None):
    torch = _torch()
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
    from mojo_opset_tpu_torch.utils.weights import load_numpy_state

    model = Qwen3ForCausalLM(Qwen3Config(**cfg, dtype=torch.float32, quant=quant), device="cpu")
    return load_numpy_state(model, state)


def _qwen3_moe(cfg: dict, state: dict):
    torch = _torch()
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3MoeConfig, Qwen3MoeForCausalLM
    from mojo_opset_tpu_torch.utils.weights import load_numpy_state

    model = Qwen3MoeForCausalLM(Qwen3MoeConfig(**cfg, dtype=torch.float32), device="cpu")
    return load_numpy_state(model, state)


def _generate(model, ids, lens, steps=STEPS, fused=False):
    from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel

    gen = MojoGenerator(PagedAttentionGenerationModel(model, block_size=BLOCK), None, GreedySampler(),
                        max_new_tokens=steps)
    return np.asarray(gen.generate_from_ids(ids, lens, ignore_eos=True, fused_decode=fused))


def _prefill_logits(model, ids, lens):
    from mojo_opset_tpu_torch.runtime import PagedAttentionGenerationModel

    logits, session = PagedAttentionGenerationModel(model, block_size=BLOCK)(ids, context_input_len=lens)
    return logits.numpy(), session.num_kv_heads, tuple(session.caches.key(0).shape)


def _serve(model, ids, lens):
    logits, kv_heads, cache_shape = _prefill_logits(model, ids, lens)
    return dict(stepwise=_generate(model, ids, lens), fused=_generate(model, ids, lens, fused=True),
                logits=logits, kv_heads=kv_heads, cache_shape=cache_shape,
                local_num_kv_heads=model.config.model_config.local_num_kv_heads,
                tp=model.config.parallel_config.ATTN_TP_SIZE)


def _continuous(model, prompts, steps):
    from mojo_opset_tpu_torch.runtime import ContinuousBatchingGenerator

    gen = ContinuousBatchingGenerator(model, batch_slots=2, block_size=BLOCK, max_new_tokens=steps)
    rids = [gen.submit(p) for p in prompts]
    out = gen.run()
    return [np.asarray(out[r]) for r in rids]


def _chunk(a, n, r, axis):
    return np.split(np.asarray(a), n, axis=axis)[r]


# ---------------------------------------------------------------- scenarios: dense Qwen3


def debugger_tp2(meshes, inp):
    """A tp 2 Qwen3's prefill logits and greedy tokens with the precision
    debugger off, then on (every op compared, every Gemm dumped: the
    row-parallel ones carry an all_reduce and the lm_head an all_gather as
    forward hooks) in log and in replace mode."""
    from mojo_opset_tpu_torch.parallel import qwen3_tp_rules, shard_model
    from mojo_opset_tpu_torch.utils.debugger import MojoDebugger

    d = inp["dense"]
    model = shard_model(_qwen3(d["cfg"], d["state"]), meshes["tp2"], qwen3_tp_rules("tp"))
    out = {"off": (_prefill_logits(model, d["ids"], d["lens"])[0], _generate(model, d["ids"], d["lens"]))}
    for mode in ("log", "replace"):
        MojoDebugger.enable(compare="*:*", dump="*:Gemm", dump_dir=os.path.join(inp["workdir"], f"dump_{mode}"),
                            compare_mode=mode)
        try:
            out[mode] = (_prefill_logits(model, d["ids"], d["lens"])[0], _generate(model, d["ids"], d["lens"]))
        finally:
            MojoDebugger.disable()
        out[f"{mode}_counts"] = dict(MojoDebugger.counts)
        out[f"{mode}_worst"] = max(r["max_abs"] for r in MojoDebugger.records)
    return out




def dense_tp4(meshes, inp):
    from mojo_opset_tpu_torch.parallel import qwen3_tp_rules, shard_model

    d = inp["dense"]
    model = shard_model(_qwen3(d["cfg"], d["state"]), meshes["tp4"], qwen3_tp_rules("tp"))
    out = _serve(model, d["ids"], d["lens"])
    out["continuous"] = _continuous(model, d["prompts"], d["cb_steps"])
    out["q_rows"] = tuple(model.model.layers[0].self_attn.q_proj.weight.shape)
    return out


def dense_tp2(meshes, inp):
    from mojo_opset_tpu_torch.parallel import qwen3_tp_rules, shard_model

    d = inp["dense"]
    model = shard_model(_qwen3(d["cfg"], d["state"]), meshes["dp2_tp2"], qwen3_tp_rules("tp"))
    out = _serve(model, d["ids"], d["lens"])
    out["continuous"] = _continuous(model, d["prompts"], d["cb_steps"])
    return out


def styles_plan_tp4(meshes, inp):
    from mojo_opset_tpu_torch.parallel import MojoQKVColwiseParallel, MojoTensorParallel, mojo_parallelize_module

    d = inp["dense"]
    heads, kv = d["cfg"]["num_attention_heads"], d["cfg"]["num_key_value_heads"]
    plan = {"self_attn": MojoQKVColwiseParallel(num_heads=heads, num_kv_heads=kv), "mlp": MojoTensorParallel()}
    model = mojo_parallelize_module(_qwen3(d["cfg"], d["state"]), meshes["tp4"], plan)
    return _serve(model, d["ids"], d["lens"])


def kv_replicated_tp4(meshes, inp):
    from mojo_opset_tpu_torch.parallel import qwen3_tp_rules, shard_model

    d = inp["kv2"]
    model = shard_model(_qwen3(d["cfg"], d["state"]), meshes["tp4"], qwen3_tp_rules("tp"))
    out = _serve(model, d["ids"], d["lens"])
    attn = model.model.layers[0].self_attn
    out["heads"] = (attn.num_heads, attn.num_kv_heads)
    out["k_proj"] = attn.k_proj.weight.numpy()
    return out


def w8a8_tp2(meshes, inp):
    from mojo_opset_tpu_torch.parallel import qwen3_tp_rules, shard_model

    d = inp["w8a8"]
    model = shard_model(_qwen3(d["cfg"], d["state"], quant="w8a8"), meshes["dp2_tp2"], qwen3_tp_rules("tp"))
    layer = model.model.layers[0]
    assert layer.self_attn.attn_quant.amax_group is meshes["dp2_tp2"].group("tp")
    assert layer.mlp.act_quant.amax_group is meshes["dp2_tp2"].group("tp")
    out = _serve(model, d["ids"], d["lens"])
    out["q_scale"] = layer.self_attn.q_proj.weight_scale.numpy()
    out["o_scale"] = layer.self_attn.o_proj.weight_scale.numpy()
    return out


def graph_over_gloo(meshes, inp):
    from mojo_opset_tpu_torch.parallel import qwen3_tp_rules, shard_model
    from mojo_opset_tpu_torch.runtime import FusedDecode, PagedAttentionGenerationModel

    d = inp["dense"]
    model = shard_model(_qwen3(d["cfg"], d["state"]), meshes["tp4"], qwen3_tp_rules("tp"))
    errors = []
    for make in (lambda: PagedAttentionGenerationModel(model, block_size=BLOCK, device_graph=True),
                 lambda: FusedDecode(model, device_graph=True)):
        try:
            make()
            errors.append(None)
        except ValueError as err:
            errors.append(str(err))
    eager = PagedAttentionGenerationModel(model, block_size=BLOCK)  # device_graph=None: eager on the CPU
    return dict(errors=errors, eager_graph=eager.device_graph)


# ---------------------------------------------------------------- scenarios: ops, embedding, checkpoint, meshes


def comm_ops(meshes, inp):
    torch = _torch()
    import mojo_opset_tpu_torch as tm

    mesh = meshes["dp2_tp2"]
    group, n, r = mesh.group("tp"), mesh.size("tp"), mesh.rank("tp")
    o = inp["ops"]
    t = torch.from_numpy
    x, w, b = o["x"], o["w"], o["b"]
    out = {}
    out["gemm_all_reduce"] = tm.MojoGemmAllReduce(t(_chunk(w, n, r, 1)), bias=t(b), group=group)(
        t(_chunk(x, n, r, 1))).numpy()
    out["all_gather_gemm"] = tm.MojoAllGatherGemm(t(w), group=group)(t(_chunk(x, n, r, 0))).numpy()
    out["gemm_reduce_scatter"] = tm.MojoGemmReduceScatter(t(_chunk(w, n, r, 1)), group=group)(
        t(_chunk(x, n, r, 1))).numpy()
    out["gemm_all2all"] = tm.MojoGemmAll2All(t(w), group=group, scatter_dim=1, gather_dim=0)(
        t(_chunk(x, n, r, 0))).numpy()
    q = o["quant"]
    out["quant_gemm_all2all"] = tm.MojoQuantGemmAll2All(
        t(_chunk(q["w"], n, r, 0)), t(_chunk(q["ws"], n, r, 0)), group=group, output_dtype=torch.float32)(
        t(q["x"]), t(q["ts"])).numpy()
    out["all2all_quant_gemm"] = tm.MojoAll2AllQuantGemm(t(q["w"]), t(q["ws"]), group=group,
                                                        output_dtype=torch.float32)(
        t(_chunk(q["x"], n, r, 1)), t(q["ts"])).numpy()
    return out


def parallel_embedding(meshes, inp):
    torch = _torch()
    from mojo_opset_tpu_torch.core.operators import MojoEmbedding
    from mojo_opset_tpu_torch.parallel.styles import shard_embedding

    e = inp["embedding"]
    out = {}
    for name, mesh in (("tp4", meshes["tp4"]), ("tp2", meshes["dp2_tp2"])):
        full = MojoEmbedding(*e["table"].shape, device="cpu")
        full.weight.data.copy_(torch.from_numpy(e["table"]))
        emb = shard_embedding(full, mesh.size("tp"), mesh.rank("tp"), mesh.group("tp"))
        ids = torch.from_numpy(e["ids"])
        hidden = torch.from_numpy(e["hidden"])
        out[name] = dict(lookup=emb(ids).numpy(), rows=emb.weight.shape[0],
                         logits=emb.gather_logits(hidden @ emb.weight.t()).numpy())
    return out


def checkpoint_roundtrip(meshes, inp):
    torch = _torch()
    from mojo_opset_tpu_torch.parallel import (
        mojo_parallel_load_state_dict_naive,
        mojo_parallel_save_state_dict_naive,
        qwen3_tp_rules,
        shard_model,
        stat_dict_rename_hook,
    )

    d = inp["dense"]
    mesh = meshes["dp2_tp2"]
    model = shard_model(_qwen3(d["cfg"], d["state"]), mesh, qwen3_tp_rules("tp"))
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    path = os.path.join(inp["workdir"], f"ckpt_{mesh.rank('dp')}_{mesh.rank('tp')}.pkl")
    mojo_parallel_save_state_dict_naive(model, path, mesh_coords=dict(mesh.coords))
    for v in model.state_dict().values():
        v.zero_()
    hook = stat_dict_rename_hook(dict(mesh.coords))
    mojo_parallel_load_state_dict_naive(model, path, rename_hook=hook)
    missing = None
    try:
        mojo_parallel_load_state_dict_naive(model, path)
    except KeyError as err:
        missing = str(err)
    return dict(equal=all(torch.equal(saved[k], v) for k, v in model.state_dict().items()),
                name=hook("a.weight"), missing=missing)


def afd_meshes(meshes, inp):
    torch = _torch()
    from mojo_opset_tpu_torch.parallel import local_mesh_for_role, mesh_from_parallel_config
    from mojo_opset_tpu_torch.runtime import AFDRole, MojoParallelConfig
    from mojo_opset_tpu_torch.runtime.parallel import dp_allreduce, merge_group_and_share_ffn

    config = MojoParallelConfig(AFD_ENABLED=True, ATTN_DP_SIZE=2, FFN_EP_SIZE=2)
    attn, ffn = mesh_from_parallel_config(config)
    role = local_mesh_for_role(config, AFDRole.ATTN)
    dp = meshes["dp2_tp2"]
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 10 * dp.rank("dp")
    merged = merge_group_and_share_ffn(x, dp.group("dp"), lambda h: h * 3)
    return dict(attn=None if attn is None else (attn.shape, attn.coords),
                ffn=None if ffn is None else (ffn.shape, ffn.coords),
                role=None if role is None else role.coords, x=x.numpy(), merged=merged.numpy(),
                summed=dp_allreduce(x.clone(), dp.group("dp")).numpy())


# ---------------------------------------------------------------- scenarios: MoE


def moe_tp2_ep2(meshes, inp):
    from mojo_opset_tpu_torch.parallel import moe_ep_rules, qwen3_tp_rules, shard_model

    d = inp["moe"]
    model = shard_model(_qwen3_moe(d["cfg"], d["state"]), meshes["tp2_ep2"],
                        qwen3_tp_rules("tp") + moe_ep_rules("ep"))
    mlp = model.layers[0].mlp
    out = _serve(model, d["ids"], d["lens"])
    out["experts"] = (mlp.ep_start, mlp.ep_end, mlp.experts.up_proj_weight.shape[0])
    return out


def _load_moe(moe, arrays, gate):
    torch = _torch()
    moe.gating.gate_weight.data.copy_(torch.from_numpy(gate))
    for k, v in arrays.items():
        if k.endswith("smooth"):
            getattr(moe.experts, k.replace("smooth", "proj_quantize")).inv_smooth_scale.data.copy_(torch.from_numpy(v))
        else:
            getattr(moe.experts, k).data.copy_(torch.from_numpy(v))
    return moe


def quant_moe_ep2(meshes, inp):
    torch = _torch()
    import mojo_opset_tpu_torch as tm
    from mojo_opset_tpu_torch.parallel import MojoExpertParallel

    q = inp["quant_moe"]
    E, K, H, I = q["dims"]
    moe = _load_moe(tm.MojoQuantMoE(E, K, H, I, device="cpu"), q["arrays"], q["gate"])
    MojoExpertParallel().apply(moe, meshes["tp2_ep2"])
    return dict(out=moe(torch.from_numpy(q["x"])).numpy(), experts=(moe.ep_start, moe.ep_end),
                kernel=type(moe.experts).__name__)


def moe_dp_input_ep4(meshes, inp):
    torch = _torch()
    import mojo_opset_tpu_torch as tm

    m = inp["moe_op"]
    E, K, H, I = m["dims"]
    mesh = meshes["ep4"]
    moe = _load_moe(tm.MojoMoE(E, K, H, I, device="cpu"), m["arrays"], m["gate"])
    moe.shard_experts(ep_group=mesh.group("ep"), dp_input=True)
    x = _chunk(m["x"], mesh.size("ep"), mesh.rank("ep"), 0)
    return dict(out=moe(torch.from_numpy(np.ascontiguousarray(x))).numpy())


def moe_uneven_ep4(meshes, inp):
    torch = _torch()
    import mojo_opset_tpu_torch as tm
    from mojo_opset_tpu_torch.parallel import MojoExpertParallel

    m = inp["moe_uneven"]
    E, K, H, I = m["dims"]
    out = {}
    for tier in ("ref", "cuda"):
        moe = _load_moe(tm.MojoMoE.get_backend_impl(tier)(E, K, H, I, device="cpu"), m["arrays"], m["gate"])
        MojoExpertParallel().apply(moe, meshes["ep4"])
        out[tier] = moe(torch.from_numpy(m["x"])).numpy()
    out["experts"] = (moe.ep_start, moe.ep_end)
    return out


# ---------------------------------------------------------------- scenarios: training and the rest of the layer


def _numpy(params) -> dict:
    return {name: p.detach().numpy().copy() for name, p in params}


def _train(mesh, d: dict, loss_kw: dict, split_embedding: bool = False) -> dict:
    """One step of ``d``'s model on ``mesh`` (this dp rank's rows of the batch): the loss and every gradient after
    ``finish_gradients`` by name, then every parameter after one AdamW step at optax.adamw(1e-4)'s settings."""
    torch = _torch()
    import mojo_opset_tpu_torch as tm
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.parallel import qwen3_tp_rules, shard_model
    from mojo_opset_tpu_torch.parallel.styles import replace_module, shard_embedding
    from mojo_opset_tpu_torch.parallel.training import adamw, finish_gradients, train_loss, valid_tokens
    from mojo_opset_tpu_torch.runtime import comm_context

    model = shard_model(_qwen3(d["cfg"], d["state"]), mesh, qwen3_tp_rules("tp"))
    if split_embedding:  # a vocabulary the rules leave whole (it does not divide): the ceil split by hand
        replace_module(model, "model.embed_tokens", shard_embedding(model.model.embed_tokens, mesh.size("tp"),
                                                                    mesh.rank("tp"), mesh.group("tp")))
    model.requires_grad_(True)
    dp, dp_rank = (mesh.size("dp"), mesh.rank("dp")) if "dp" in mesh.shape else (1, 0)
    dp_group = mesh.group("dp") if "dp" in mesh.shape else None
    B = d["ids"].shape[0]
    rows = slice(dp_rank * B // dp, (dp_rank + 1) * B // dp)
    ids, targets = torch.from_numpy(d["ids"][rows]), torch.from_numpy(d["targets"][rows])
    golden = sum(cls.golden_calls for cls in kernels.golden_classes())
    loss = train_loss(model, ids, targets, tm.MojoFusedLinearCrossEntropyFunction(**loss_kw))
    loss.backward()
    weight = valid_tokens(targets)
    finish_gradients(model, dp_group, weight)
    out = dict(loss=float(comm_context.mean_over_group(loss.detach(), dp_group, weight)), coords=dict(mesh.coords),
               grads=_numpy((n, p.grad) for n, p in model.named_parameters()),
               golden=sum(cls.golden_calls for cls in kernels.golden_classes()) - golden,
               vocab=tuple(model.lm_head_vocab[1:]) if model.lm_head_vocab is not None else None)
    adamw(model).step()
    out["params"] = _numpy(model.named_parameters())
    return out


def train_dp2_tp2(meshes, inp):
    return _train(meshes["dp2_tp2"], inp["train"], {})


def train_kv_replicated_tp4(meshes, inp):
    return _train(meshes["tp4"], inp["train_kv2"], {})


def train_tied_uneven_tp4(meshes, inp):
    return _train(meshes["tp4"], inp["train_tied"], {}, split_embedding=True)


def train_options_dp2_tp2(meshes, inp):
    d = inp["train_options"]
    return _train(meshes["dp2_tp2"], d, d["loss_kw"])


def speculative_tp4(meshes, inp):
    from mojo_opset_tpu_torch.modeling.qwen3 import quantize_qwen3
    from mojo_opset_tpu_torch.parallel import qwen3_tp_rules, shard_model
    from mojo_opset_tpu_torch.runtime import SpeculativeDecoder

    d = inp["speculative"]
    model = _qwen3(d["cfg"], d["state"])
    draft = shard_model(quantize_qwen3(model), meshes["tp4"], qwen3_tp_rules("tp"))  # quantized, then sharded
    target = shard_model(model, meshes["tp4"], qwen3_tp_rules("tp"))
    spec = SpeculativeDecoder(target, draft, k=3, mode="greedy", block_size=BLOCK)
    got = spec.generate(d["ids"], d["lens"], max_new_tokens=d["steps"])
    return dict(tokens=np.asarray(got), draft=type(draft.model.layers[0].self_attn.q_proj).__name__,
                draft_rows=tuple(draft.model.layers[0].self_attn.q_proj.weight.shape), rounds=spec.last_rounds)


def _c8(mesh, d):
    from mojo_opset_tpu_torch.parallel import qwen3_tp_rules, shard_model
    from mojo_opset_tpu_torch.runtime import PagedAttentionGenerationModel

    model = shard_model(_qwen3(d["cfg"], d["state"], quant="w8a8"), mesh, qwen3_tp_rules("tp"))
    _, session = PagedAttentionGenerationModel(model, block_size=BLOCK)(d["ids"], context_input_len=d["lens"])
    layers = range(len(session.caches.key_scales))
    return dict(tokens=_generate(model, d["ids"], d["lens"]), cache=tuple(session.caches.key(0).shape),
                key_scales=[session.caches.key_scale(i).numpy() for i in layers],
                value_scales=[session.caches.value_scale(i).numpy() for i in layers],
                kv_heads=model.config.model_config.local_num_kv_heads)


def c8_tp2(meshes, inp):
    return _c8(meshes["dp2_tp2"], inp["c8"])


def c8_kv_replicated_tp4(meshes, inp):
    return _c8(meshes["tp4"], inp["c8_kv2"])


def ring_ops(meshes, inp):
    """The ring AllGatherGemm and GemmReduceScatter (the cuda tier's; the ring on gloo CPU tensors) at world 4 and
    2, each rank's input its shard of JAX's case; and a gather dim 1, which takes the golden."""
    torch = _torch()
    import mojo_opset_tpu_torch as tm

    o = inp["ring"]
    t = torch.from_numpy
    out = {}
    for world, mesh, axis in ((4, meshes["tp4"], "tp"), (2, meshes["dp2_tp2"], "tp")):
        group, n, r = mesh.group(axis), mesh.size(axis), mesh.rank(axis)
        gather = tm.MojoAllGatherGemm(t(o["w"]), bias=t(o["b"]), group=group)
        scatter = tm.MojoGemmReduceScatter(t(_chunk(o["w"], n, r, 1)), bias=t(o["b"]), group=group)
        out[world] = dict(all_gather_gemm=gather(t(_chunk(o["x"], n, r, 0))).numpy(),
                          gemm_reduce_scatter=scatter(t(_chunk(o["x"], n, r, 1))).numpy(),
                          tiers=(type(gather).__name__, type(scatter).__name__))
    mesh = meshes["tp4"]
    out["gather_dim1"] = tm.MojoAllGatherGemm(t(o["w"]), bias=t(o["b"]), group=mesh.group("tp"), gather_dim=1)(
        t(np.ascontiguousarray(_chunk(o["x"], 4, mesh.rank("tp"), 1)))).numpy()
    return out


def dryrun(meshes, inp):
    from mojo_opset_tpu_torch.parallel.training import dryrun_step

    return dryrun_step(meshes["dp2_tp2"], "cpu")


SCENARIOS = {f.__name__: f for f in (
    dense_tp4, dense_tp2, styles_plan_tp4, kv_replicated_tp4, w8a8_tp2, graph_over_gloo, comm_ops,
    parallel_embedding, checkpoint_roundtrip, afd_meshes, moe_tp2_ep2, quant_moe_ep2, moe_dp_input_ep4,
    moe_uneven_ep4, debugger_tp2, train_dp2_tp2, train_kv_replicated_tp4, train_tied_uneven_tp4,
    train_options_dp2_tp2, speculative_tp4, c8_tp2, c8_kv_replicated_tp4, ring_ops, dryrun)}


def main(rank: int, world: int, workdir: str) -> None:
    torch = _torch()
    torch.set_num_threads(1)
    import torch.distributed as dist

    from mojo_opset_tpu_torch.parallel import build_mesh, init_distributed

    init_distributed(rank, world, f"file://{workdir}/rendezvous", device="cpu", timeout=timedelta(seconds=120))
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    inputs["workdir"] = workdir
    if world == 4:
        meshes = {"tp4": build_mesh((4,), ("tp",)), "dp2_tp2": build_mesh((2, 2), ("dp", "tp")),
                  "tp2_ep2": build_mesh((2, 2), ("tp", "ep")), "ep4": build_mesh((4,), ("ep",))}
    else:
        meshes = {f"tp{world}": build_mesh((world,), ("tp",))}
    results = {}
    for name in inputs["scenarios"]:
        try:
            results[name] = SCENARIOS[name](meshes, inputs)
        except Exception:  # noqa: BLE001 - the test that reads this scenario fails with the traceback
            results[name] = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
