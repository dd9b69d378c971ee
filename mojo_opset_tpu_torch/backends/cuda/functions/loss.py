"""cuda-tier fused linear + cross-entropy: kernel N (``csrc/flce.cu``)
forward statistics and backward under one ``torch.autograd.Function``.

Counterpart of the JAX package's ``backends/pallas/functions/loss.py:26-79``
(``PallasFusedLinearCrossEntropyFunction`` and ``...Loss`` over ``flce``'s
``jax.custom_vjp``). The forward saves x, w, target and lse, never the
logits (JAX ``kernels/flce.py:350-355``); the backward recomputes them
tile by tile. ``return_z_loss``, ``ignore_index``, ``label_smoothing``,
``lse_square_scale``, ``softcap`` and ``mean``/``sum`` reduction run on the
kernel; ``chunk_size`` is the golden's option and the kernel has no use for
it. ``bias``, ``ce_weight`` and ``reduction='none'``, which the TPU kernel
does not take either, run the golden: explicitly, counted in
``golden_calls`` (JAX :26-35). JAX's ``N % 8``, ``H % 128`` and
``H <= 8192`` gates are TPU limits and are not carried over; kernel N
raises where its own limits are not met. It is the default tier (JAX's
``dispatch_default = False`` was set from a TPU measurement), decided from
the H100: at Qwen3-4B's train step (B 2 x S 2048, V 151936, bf16) the step
took 298.1 ms on kernel N against 300.0 ms on the chunked golden loss, at
a peak of 44.9 against 47.7 GiB (chip_smoke.py phase 10, NVIDIA H100 80GB
HBM3 at 700 W; PERF.md): as fast, and 2.8 GiB smaller.

Vocab-parallel (``vocab_shard``): N runs on the shard's rows with the
targets shifted by its first row; the statistics are combined over the
group (``combine_row_stats``: plain torch around N), the backward's dz runs on
the shard with the whole vocabulary's lse and smoothing spread, dx is
summed over the group and dw stays the shard's. Every part runs on N.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.flce import (
    backward_coefficients,
    flce_backward,
    flce_stats,
    loss_from_stats,
)
from mojo_opset_tpu_torch.core.functions.loss import (
    MojoFusedLinearCrossEntropyFunction,
    MojoFusedLinearCrossEntropyLoss,
    combine_row_stats,
)
from mojo_opset_tpu_torch.runtime import comm_context


def _shifted(target: torch.Tensor, start: int) -> torch.Tensor:
    """The targets as a vocab shard starting at row ``start`` reads them (outside it: no target there)."""
    return target if start == 0 else (target - start).to(torch.int32).contiguous()


class FlceVJP(torch.autograd.Function):
    """``apply(x, w, target, options, fwd, bwd, vocab_shard=None) -> (loss,
    z_loss)``: ``options`` is ``(ignore_index, lse_square_scale,
    label_smoothing, reduction, softcap)``; ``fwd``/``bwd`` are kernel N's
    ``flce_stats`` and ``flce_backward`` (a plain twin passes their plain
    versions); ``vocab_shard`` (``core.functions.loss.VocabShard``) makes
    ``w`` a vocab shard."""

    @staticmethod
    def forward(ctx, x, w, target, options, fwd, bwd, vocab_shard=None):
        ignore_index, lse_square_scale, label_smoothing, reduction, softcap = options
        x = x.contiguous()
        target = target.to(torch.int32).contiguous()
        group, start, vocab_size = (None, 0, w.shape[0]) if vocab_shard is None else vocab_shard
        lse, tl, zs = combine_row_stats(*fwd(x, w, _shifted(target, start), softcap), group)
        loss, z_loss = loss_from_stats(lse, tl, zs, target, vocab_size, ignore_index, lse_square_scale,
                                       label_smoothing, reduction)
        ctx.save_for_backward(x, w, target, lse)
        ctx.options, ctx.bwd, ctx.shard = options, bwd, (group, start, vocab_size)
        return loss, z_loss

    @staticmethod
    def backward(ctx, g_loss, g_z):
        x, w, target, lse = ctx.saved_tensors
        ignore_index, lse_square_scale, label_smoothing, reduction, softcap = ctx.options
        group, start, vocab_size = ctx.shard
        a, c = backward_coefficients(g_loss, g_z, lse, target, ignore_index, lse_square_scale, reduction)
        dx, dw = ctx.bwd(x, w, _shifted(target, start), lse, a, c, softcap, label_smoothing,
                         need_dx=ctx.needs_input_grad[0], need_dw=ctx.needs_input_grad[1], vocab_size=vocab_size)
        if dx is not None:
            dx = comm_context.all_reduce(dx, group)  # the input is whole on every rank: its gradient, too
        return dx, dw, None, None, None, None, None


class _KernelTier:
    """What the two forms share: ``fwd`` and ``bwd`` are kernel N's wrappers
    (a plain twin on the card sets them to ``flce_stats_plain`` and
    ``flce_backward_plain``); ``golden_calls`` counts, per class, the calls
    that took the golden."""

    golden_calls = 0
    fwd = staticmethod(flce_stats)
    bwd = staticmethod(flce_backward)

    def _run(self, x, w, target, bias, ce_weight, vocab_shard, golden):
        if bias is not None or ce_weight is not None or self.reduction not in ("mean", "sum"):
            type(self).golden_calls += 1
            return golden()
        options = (self.ignore_index, self.lse_square_scale, self.label_smoothing, self.reduction, self.softcap)
        loss, z_loss = FlceVJP.apply(x, w, target, options, self.fwd, self.bwd, vocab_shard)
        return (loss, z_loss) if self.return_z_loss else loss


class CudaFusedLinearCrossEntropyFunction(_KernelTier, MojoFusedLinearCrossEntropyFunction):
    def forward(self, input_tensor, weight, target, bias=None, ce_weight=None, vocab_shard=None):
        return self._run(input_tensor, weight, target, bias, ce_weight, vocab_shard,
                         lambda: MojoFusedLinearCrossEntropyFunction.forward(self, input_tensor, weight, target, bias,
                                                                             ce_weight, vocab_shard))


class CudaFusedLinearCrossEntropyLoss(_KernelTier, MojoFusedLinearCrossEntropyLoss):
    """The module form, the weight first."""

    def forward(self, lin_weight, input_tensor, target, bias=None, ce_weight=None, vocab_shard=None):
        return self._run(input_tensor, lin_weight, target, bias, ce_weight, vocab_shard,
                         lambda: MojoFusedLinearCrossEntropyLoss.forward(self, lin_weight, input_tensor, target, bias,
                                                                         ce_weight, vocab_shard))
