"""Fused linear + cross-entropy loss, the golden (counterpart of the JAX
package's ``core/functions/loss.py``: ``_ce_from_logits`` :27,
``fused_linear_cross_entropy`` :85, ``MojoFusedLinearCrossEntropyFunction``
:157, ``MojoFusedLinearCrossEntropyLoss`` :207).

The lm_head product and the CE loss: ``ce_weight``, ``ignore_index``,
label smoothing, z-loss (``lse_square_scale``) and softcap, ``mean`` or
``sum`` (or, unchunked, ``none``) reduction. The backward is autograd of
this math. With ``chunk_size`` the token rows run in blocks, so no
(N, V) product is computed at once; autograd still keeps each block's fp32
logits for the backward, as JAX's ``lax.map`` under ``jax.grad`` keeps its
residuals. The ``cuda`` tier (``backends/cuda/functions/loss.py``) runs
kernel N, which keeps no logits.

Vocab-parallel (JAX: the same function on a vocab-sharded
``lm_head_weight``, whose collectives GSPMD places): with ``vocab_shard``
(a ``VocabShard``) the weight (and a bias) are this rank's rows
``[start, start + rows)`` of a vocabulary of ``vocab_size`` rows, sharded
over ``group``; the input and the targets are whole on every rank. Each
row's log-sum-exp, target logit and logit sum are combined over the group
(the target logit read on the rank whose rows hold the target), the label
smoothing spreads over the whole vocabulary, ``ce_weight`` is the whole
vocabulary's, and the input's gradient is summed over the group
(``comm_context.copy_to_group``), so every rank holds the loss and its
gradients as the unsharded function gives them, the weight's for its rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mojo_opset_tpu_torch.core.function import MojoFunction
from mojo_opset_tpu_torch.runtime import comm_context


class VocabShard(NamedTuple):
    """A vocab-parallel LM head: this rank's weight rows are rows
    ``[start, start + rows)`` of a ``vocab_size``-row vocabulary, the rest on
    the other ranks of ``group``."""

    group: object
    start: int
    vocab_size: int


def combine_row_stats(lse: torch.Tensor, tl: torch.Tensor, zsum: torch.Tensor, group):
    """The whole vocabulary's per-row ``(log-sum-exp, target logit, logit
    sum)`` from each vocab shard's over ``group``: the log-sum-exp of the
    shards' (shifted by their largest, so no exp overflows), the others
    summed (a target outside a shard reads 0 there); differentiable
    (``sum_over_group``) where autograd tracks them. A group of one gives
    its statistics bit for bit."""
    if group is None:
        return lse, tl, zsum
    top = comm_context.all_reduce(lse.detach().clone(), group, "max")
    lse = top + torch.log(comm_context.sum_over_group(torch.exp(lse - top), group))
    return lse, comm_context.sum_over_group(tl, group), comm_context.sum_over_group(zsum, group)


def _row_stats(logits: torch.Tensor, safe_target: torch.Tensor, shard: Optional[VocabShard]):
    """Each row's (log-sum-exp, target logit, mean logit) over the whole vocabulary."""
    if shard is None:
        return torch.logsumexp(logits, dim=-1), logits.gather(-1, safe_target[:, None])[:, 0], logits.mean(dim=-1)
    local = safe_target - shard.start
    hit = (local >= 0) & (local < logits.shape[-1])
    tl = torch.where(hit, logits.gather(-1, torch.where(hit, local, 0)[:, None])[:, 0], 0.0)
    lse, tl, zsum = combine_row_stats(torch.logsumexp(logits, dim=-1), tl, logits.sum(dim=-1), shard.group)
    return lse, tl, zsum / shard.vocab_size


def _ce_from_logits(
    logits: torch.Tensor,  # (N, V) fp32
    target: torch.Tensor,  # (N,)
    ce_weight: Optional[torch.Tensor],
    ignore_index: int,
    lse_square_scale: float,
    label_smoothing: float,
    reduction: str,
    softcap: Optional[float],
    vocab_shard: Optional[VocabShard] = None,
):
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    valid = target != ignore_index
    safe_target = torch.where(valid, target, 0).long()

    lse, target_logit, mean_logit = _row_stats(logits, safe_target, vocab_shard)
    if label_smoothing > 0.0:
        smooth_loss = -mean_logit
        nll = (1.0 - label_smoothing) * (lse - target_logit) + label_smoothing * (lse + smooth_loss)
    else:
        nll = lse - target_logit

    if ce_weight is not None:
        w = ce_weight[safe_target]
        nll = nll * w
        denom = torch.where(valid, w, 0.0).sum()
    else:
        denom = valid.sum()

    nll = torch.where(valid, nll, 0.0)
    if reduction == "mean":
        loss = nll.sum() / denom.float().clamp(min=1.0)
    elif reduction == "sum":
        loss = nll.sum()
    else:
        loss = nll

    z_loss = None
    if lse_square_scale > 0.0:
        lse_valid = torch.where(valid, lse, 0.0)
        z_sum = lse_square_scale * (lse_valid * lse_valid).sum()
        # a "sum" chunk keeps its z-loss undivided: the chunked caller divides
        # the total by the global count of valid rows
        z_loss = z_sum if reduction == "sum" else z_sum / valid.sum().clamp(min=1)
        if reduction != "none":
            loss = loss + z_loss
    return loss, z_loss


def _logits(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    # the product in the input dtype (fp32 sums), then fp32, as the JAX golden's astype
    logits = torch.matmul(x, weight.t()).float()
    return logits if bias is None else logits + bias.float()


def fused_linear_cross_entropy(
    input_tensor: torch.Tensor,  # (N, H)
    weight: torch.Tensor,  # (V, H)
    target: torch.Tensor,  # (N,)
    bias: Optional[torch.Tensor] = None,
    ce_weight: Optional[torch.Tensor] = None,
    ignore_index: int = -100,
    lse_square_scale: float = 0.0,
    label_smoothing: float = 0.0,
    reduction: str = "mean",
    softcap: Optional[float] = None,
    return_z_loss: bool = False,
    chunk_size: Optional[int] = None,
    vocab_shard: Optional[VocabShard] = None,
):
    """The loss of ``input_tensor @ weight.T (+ bias)`` against ``target``;
    with ``return_z_loss``, ``(loss, z_loss)``. ``chunk_size`` takes the
    rows in blocks of that many (``mean`` and ``sum`` only). With
    ``vocab_shard`` the weight and bias are this rank's vocabulary rows
    (see the module's docstring)."""
    if vocab_shard is not None:
        input_tensor = comm_context.copy_to_group(input_tensor, vocab_shard.group)
    if chunk_size is None or input_tensor.shape[0] <= chunk_size:
        loss, z_loss = _ce_from_logits(
            _logits(input_tensor, weight, bias), target, ce_weight, ignore_index, lse_square_scale,
            label_smoothing, reduction, softcap, vocab_shard,
        )
        if return_z_loss:
            return loss, (z_loss if z_loss is not None else torch.zeros((), device=loss.device))
        return loss
    if reduction not in ("mean", "sum"):
        raise NotImplementedError("chunked fused CE supports mean/sum reduction")

    total = denom = n_valid = z_total = 0.0
    for start in range(0, input_tensor.shape[0], chunk_size):
        t = target[start:start + chunk_size]
        loss_sum, z_sum = _ce_from_logits(
            _logits(input_tensor[start:start + chunk_size], weight, bias), t, ce_weight, ignore_index,
            lse_square_scale, label_smoothing, "sum", softcap, vocab_shard,
        )
        valid = t != ignore_index
        if z_sum is not None:
            loss_sum = loss_sum - z_sum  # recombined after the global division
            z_total = z_total + z_sum
        total = total + loss_sum
        denom = denom + (valid.sum() if ce_weight is None else torch.where(valid, ce_weight[torch.where(
            valid, t, 0).long()], 0.0).sum())
        n_valid = n_valid + valid.sum()
    if reduction == "mean":
        loss = total / torch.clamp(torch.as_tensor(denom, device=total.device).float(), min=1.0)
        # the z-loss mean divides by the unweighted count of valid rows, as the unchunked path does
        z_total = z_total / torch.clamp(torch.as_tensor(n_valid, device=total.device), min=1)
    else:
        loss = total
    if lse_square_scale > 0.0:
        loss = loss + z_total
    if return_z_loss:
        return loss, torch.as_tensor(z_total, device=loss.device)
    return loss


class _LossConfigMixin:
    """The options shared by the two loss functions below (a plain mixin,
    as ``_SWAConfigMixin``: only the classes that list it beside
    ``MojoFunction`` are core ops)."""

    def __init__(
        self,
        ignore_index: int = -100,
        lse_square_scale: float = 0.0,
        label_smoothing: float = 0.0,
        reduction: str = "mean",
        softcap: Optional[float] = None,
        return_z_loss: bool = False,
        chunk_size: Optional[int] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.ignore_index = ignore_index
        self.lse_square_scale = lse_square_scale
        self.label_smoothing = label_smoothing
        self.reduction = reduction
        self.softcap = softcap
        self.return_z_loss = return_z_loss
        self.chunk_size = chunk_size

    def _loss(self, input_tensor, weight, target, bias, ce_weight, vocab_shard=None):
        return fused_linear_cross_entropy(
            input_tensor, weight, target, bias, ce_weight,
            ignore_index=self.ignore_index, lse_square_scale=self.lse_square_scale,
            label_smoothing=self.label_smoothing, reduction=self.reduction, softcap=self.softcap,
            return_z_loss=self.return_z_loss, chunk_size=self.chunk_size, vocab_shard=vocab_shard,
        )

    def extra_repr(self) -> str:
        return (
            f"ignore_index={self.ignore_index}, lse_square_scale={self.lse_square_scale}, "
            f"label_smoothing={self.label_smoothing}, reduction={self.reduction!r}, "
            f"softcap={self.softcap}, chunk_size={self.chunk_size}"
        )


class MojoFusedLinearCrossEntropyFunction(_LossConfigMixin, MojoFunction):
    """Op form: ``forward(input, weight, target, bias, ce_weight, vocab_shard=None) -> loss``."""

    def forward(self, input_tensor, weight, target, bias=None, ce_weight=None, vocab_shard=None):
        return self._loss(input_tensor, weight, target, bias, ce_weight, vocab_shard)


class MojoFusedLinearCrossEntropyLoss(_LossConfigMixin, MojoFunction):
    """Module form, the weight first: ``forward(lin_weight, input, target,
    bias, ce_weight, vocab_shard=None) -> loss``."""

    def forward(self, lin_weight, input_tensor, target, bias=None, ce_weight=None, vocab_shard=None):
        return self._loss(input_tensor, lin_weight, target, bias, ce_weight, vocab_shard)
