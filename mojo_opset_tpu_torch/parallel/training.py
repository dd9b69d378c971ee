"""Training under a ``("dp", "tp")`` mesh: the gradient step that a sharded
backward leaves to the trainer, and the port's ``dryrun_multichip``.

Counterpart of the JAX package's ``__graft_entry__.py:54-144``
(``dryrun_multichip``): one full Qwen3 train step (forward, the fused linear
cross entropy, backward, ``optax.adamw(1e-4)``) on a dp x tp mesh under
``qwen3_tp_rules``, then a paged prefill and fused decode steps of the same
sharded model. GSPMD places every collective in JAX, the backward ones
included. Here the forward's collectives are the autograd-aware ones of
``runtime.comm_context`` (the styles place them), the loss is vocab-parallel
(``lm_head_vocab``), and two things are left after ``backward``, which
``finish_gradients`` does:

  * the gradients a tp rank holds only part of (``styles.record_partial_grad``:
    the q/k norm weights, shared by all heads, a replicated kv head's rows,
    a rank-0-only bias) are completed over the ranks that hold them;
  * every gradient is averaged over dp, each rank weighted by its share of
    the valid (not ``ignore_index``) target tokens, so the step follows the
    global mean loss, as JAX's ``jax.value_and_grad`` of the whole batch's
    mean, however the ignored rows fall.

The optimizer is ``torch.optim.AdamW`` with optax's defaults
(``weight_decay=1e-4``; torch's own default of 1e-2 would part from JAX).
Gloo processes serve on the CPU, NCCL on the card.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch
from torch import nn

from mojo_opset_tpu_torch.runtime import comm_context

ADAMW = dict(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)  # optax.adamw(1e-4)'s defaults

# __graft_entry__.py:18-30 _tiny_config
DRYRUN_CONFIG = dict(hidden_size=128, intermediate_size=256, num_attention_heads=8, num_key_value_heads=4,
                     num_hidden_layers=2, head_dim=16, vocab_size=256, max_position_embeddings=512)


def sum_partial_gradients(model: nn.Module) -> None:
    """Complete, in place, every gradient that a parallel style recorded as
    partial on this rank (``mojo_partial_grads``): summed over its group, a
    kv head's rows summed over the ranks that hold that head (through a
    buffer of all the heads, each rank's rows at its head's index, so the
    tp group serves), a rank-0-only bias's zeros kept at zero."""
    for module in model.modules():
        for name, kind, group, head in module.__dict__.get("mojo_partial_grads", ()):
            grad = getattr(module, name).grad
            if grad is None:
                continue
            if kind == "zero":
                grad.zero_()
            elif kind == "sum":
                grad.copy_(comm_context.all_reduce(grad.contiguous(), group))
            else:
                index, count = head
                buf = grad.new_zeros((count,) + tuple(grad.shape))
                buf[index] = grad
                grad.copy_(comm_context.all_reduce(buf, group)[index])


def average_gradients(model: nn.Module, group, weight=1.0) -> None:
    """Every gradient of ``model`` replaced by its mean over ``group`` (dp),
    this rank weighted by ``weight`` (``comm_context.mean_over_group``), one
    collective for each dtype over the gradients laid end to end. A group of
    one rank leaves them as they are (its mean is the gradient itself)."""
    if comm_context.group_size(group) == 1:
        return
    by_dtype = {}
    for p in model.parameters():
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        flat = comm_context.mean_over_group(flat, group, weight)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def valid_tokens(targets: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
    """The count of target tokens that are not ``ignore_index`` (a 0-d tensor): a dp rank's weight."""
    return (targets != ignore_index).sum()


def finish_gradients(model: nn.Module, dp_group=None, weight=1.0) -> None:
    """After ``backward``: the tp partial gradients completed, then every gradient averaged over dp, this rank
    weighted by ``weight`` (its valid target tokens for a mean loss)."""
    sum_partial_gradients(model)
    average_gradients(model, dp_group, weight)


def train_loss(model, input_ids: torch.Tensor, targets: torch.Tensor, loss_fn=None) -> torch.Tensor:
    """This rank's loss of ``model`` on ``input_ids`` (B, S) against ``targets`` (B, S): ``train_forward``, then
    ``loss_fn`` (the dispatched fused linear cross entropy by default) on the LM head's shard."""
    if loss_fn is None:
        from mojo_opset_tpu_torch.core.functions import MojoFusedLinearCrossEntropyFunction

        loss_fn = MojoFusedLinearCrossEntropyFunction()
    hidden = model.train_forward(input_ids)
    return loss_fn(hidden.reshape(-1, hidden.shape[-1]), model.lm_head_weight, targets.reshape(-1),
                   vocab_shard=model.lm_head_vocab)


def train_step(model, optimizer, input_ids: torch.Tensor, targets: torch.Tensor, dp_group=None, loss_fn=None,
               ignore_index: int = -100) -> torch.Tensor:
    """One step on this dp rank's batch (a ``mean`` loss): forward, loss, backward, ``finish_gradients`` (weighted
    by the valid tokens), ``optimizer.step``; returns the global loss (the dp mean, weighted the same way)."""
    loss = train_loss(model, input_ids, targets, loss_fn)
    loss.backward()
    weight = valid_tokens(targets, ignore_index)
    finish_gradients(model, dp_group, weight)
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    with torch.no_grad():
        return comm_context.mean_over_group(loss.detach(), dp_group, weight)


def adamw(model: nn.Module, **kw) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` over the parameters that train, at optax.adamw(1e-4)'s settings unless ``kw`` says
    otherwise."""
    return torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], **dict(ADAMW, **kw))


def dryrun_step(mesh, device, seed: int = 0, decode_steps: int = 4) -> dict:
    """One rank's part of ``dryrun_multichip`` on ``mesh`` (axes ``dp`` and
    ``tp``; the world already joined): the tiny Qwen3 drawn from ``seed``,
    sharded by ``qwen3_tp_rules``, one AdamW step on this dp rank's rows of a
    (max(dp, 2), 16) batch, then one paged prefill of two 12-token prompts
    and ``decode_steps`` fused greedy decode steps of the trained model.
    Returns the loss and the tokens."""
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
    from mojo_opset_tpu_torch.parallel.plans import qwen3_tp_rules, shard_model
    from mojo_opset_tpu_torch.runtime import FusedDecode, PagedAttentionGenerationModel

    device = torch.device(device)
    config = Qwen3Config(**DRYRUN_CONFIG, dtype=torch.float32)
    model = Qwen3ForCausalLM(config, device=device, generator=torch.Generator(device=device).manual_seed(seed))
    model = shard_model(model, mesh, qwen3_tp_rules("tp"))
    model.requires_grad_(True)
    dp, dp_rank = mesh.size("dp"), mesh.rank("dp")
    B, S = max(dp, 2), 16
    rng = np.random.default_rng(0)
    batch = torch.as_tensor(rng.integers(0, config.vocab_size, (B, S)), dtype=torch.long, device=device)
    rows = batch[dp_rank * B // dp:(dp_rank + 1) * B // dp]
    loss = train_step(model, adamw(model), rows[:, :-1], rows[:, 1:], mesh.group("dp"))
    ids = rng.integers(0, config.vocab_size, (2 * 12,)).astype(np.int32)
    lens = np.full((2,), 12, np.int32)
    logits, session = PagedAttentionGenerationModel(model, block_size=16)(ids, context_input_len=lens)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    tokens = FusedDecode(model, sample_method="greedy")(session, first, decode_steps)
    return dict(loss=float(loss), tokens=np.asarray(tokens.cpu()), mesh=(dp, mesh.size("tp")))


def _dryrun_rank(rank: int, world: int, init_method: str, device: Optional[str], out: str) -> None:
    from mojo_opset_tpu_torch.parallel.mesh import build_mesh, init_distributed

    import torch.distributed as dist

    if device is None or device == "cuda":
        device = f"cuda:{rank % max(1, torch.cuda.device_count())}"
    torch.set_num_threads(1)
    device = init_distributed(rank, world, init_method, device=device)
    dp = 2 if world % 2 == 0 else 1
    mesh = build_mesh((dp, world // dp), ("dp", "tp"))
    result = dryrun_step(mesh, device)
    print(f"dryrun_multichip(n={world}) rank {rank}: mesh=({dp}x{world // dp}) loss={result['loss']:.4f}; paged "
          f"prefill+decode ok, decoded shape {tuple(result['tokens'].shape)}", flush=True)
    np.savez(os.path.join(out, f"rank{rank}.npz"), loss=result["loss"], tokens=result["tokens"])
    dist.barrier()
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: Optional[str] = None, timeout: float = 600.0) -> list:
    """JAX's ``dryrun_multichip(n)`` on ``n_devices`` processes: dp 2 x tp n/2
    (dp 1 for an odd n), one rank a process, each on card ``rank`` (NCCL) or
    on the CPU (``device="cpu"``, gloo). Returns each rank's ``{"loss",
    "tokens"}``; a rank that fails raises here."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mojo_dryrun_") as tmp:
        init = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=_dryrun_rank, args=(r, n_devices, init, device, tmp)) for r in range(n_devices)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"dryrun_multichip: ranks failed (rank, exit code): {failed}")
        return [{k: v[()] if v.ndim == 0 else v for k, v in np.load(os.path.join(tmp, f"rank{r}.npz")).items()}
                for r in range(n_devices)]
