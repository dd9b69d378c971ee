"""Sampling ops (counterpart of the JAX package's
``core/operators/sampling.py:23-249``: ``MojoTopKSampling`` :29,
``MojoTopPSampling`` :91, ``MojoTopPFilter`` :124, ``MojoRejectSampling``
:143, ``MojoJoinProbRejectSampling`` :181, ``MojoApplyPenaltiesTempurate``
:214).

Plain PyTorch, golden tier only: the JAX package has no Pallas kernel for
these. A ``torch.Generator`` takes the place of the JAX ``key``; the two
draw different numbers from one seed, so every draw sits behind a pure
helper that takes the uniforms (``sample_from_uniform``,
``reject_sampling_from_uniform``, ``join_prob_reject_from_uniform``), and
the tests feed it JAX's. Without a generator an op draws from a fresh one
seeded 0, as the JAX ops fall back to ``PRNGKey(0)``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator


def _generator(generator: Optional[torch.Generator], device: torch.device) -> torch.Generator:
    return generator if generator is not None else torch.Generator(device=device).manual_seed(0)


def uniform(shape, device, generator: Optional[torch.Generator]) -> torch.Tensor:
    """U[0, 1) fp32 draws of ``shape`` on ``device``."""
    return torch.rand(shape, device=device, generator=_generator(generator, device))


def sample_from_uniform(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF categorical sample over the last dim: the first index
    whose cumulative mass exceeds ``u`` (…, 1) times the row's total, so a
    zero-probability index is never taken. Returns (…, 1) int64."""
    cdf = torch.cumsum(probs.float(), dim=-1)
    idx = (cdf <= u * cdf[..., -1:]).sum(dim=-1, keepdim=True)
    return idx.clamp(max=probs.shape[-1] - 1)


def sample_from_probs(probs: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Categorical sample over the last dim; (…, 1) int64."""
    return sample_from_uniform(probs, uniform(probs.shape[:-1] + (1,), probs.device, generator))


class MojoTopKSampling(MojoOperator):
    def __init__(
        self,
        top_k: int = 50,
        filter_value: float = -float("inf"),
        min_tokens_to_keep: int = 1,
        op_name: str = "",
        layer_idx: int = 0,
    ):
        super().__init__()
        self.op_name = op_name
        self.layer_idx = layer_idx
        self.top_k = top_k
        self.filter_value = filter_value
        self.min_tokens_to_keep = min_tokens_to_keep

    def forward(
        self, logits: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k sample; returns ``(next_probs, next_tokens)`` each (…, 1)."""
        logits = logits.float()
        top_k = max(min(self.top_k, logits.shape[-1]), self.min_tokens_to_keep)
        topk_logits, topk_indices = torch.topk(logits, top_k, dim=-1)
        probs = torch.softmax(topk_logits, dim=-1)
        select = sample_from_probs(probs, generator)
        return torch.gather(probs, -1, select), torch.gather(topk_indices, -1, select)

    def extra_repr(self) -> str:
        return f"top_k={self.top_k}, min_tokens_to_keep={self.min_tokens_to_keep}"


def _nucleus_from_topk(
    topk_logits: torch.Tensor, top_p: float, min_tokens_to_keep: int, filter_value: float
) -> torch.Tensor:
    """Nucleus mask + renormalize over DESCENDING-sorted top-k logits."""
    top_k = topk_logits.shape[-1]
    cumulative = torch.cumsum(torch.softmax(topk_logits, dim=-1), dim=-1)
    to_remove = cumulative > top_p
    if min_tokens_to_keep > 1:
        to_remove &= torch.arange(top_k, device=topk_logits.device) >= (min_tokens_to_keep - 1)
    # shift right so the first token above the threshold is kept
    to_remove = torch.cat([torch.zeros_like(to_remove[..., :1]), to_remove[..., :-1]], dim=-1)
    return torch.softmax(topk_logits.masked_fill(to_remove, filter_value), dim=-1)


def _top_p_filter(logits: torch.Tensor, top_p: float, min_tokens_to_keep: int, rand_top_k: int,
                  filter_value: float):
    """Shared nucleus filtering: (probs, indices) over the sorted top-k."""
    logits = logits.float()
    topk_logits, topk_indices = torch.topk(logits, min(rand_top_k, logits.shape[-1]), dim=-1)
    return _nucleus_from_topk(topk_logits, top_p, min_tokens_to_keep, filter_value), topk_indices


class MojoTopPSampling(MojoOperator):
    def __init__(
        self,
        top_p: float = 0.75,
        filter_value: float = -float("inf"),
        min_tokens_to_keep: int = 1,
        rand_top_k: int = 1000,
    ):
        super().__init__()
        self.top_p = top_p
        self.filter_value = filter_value
        self.min_tokens_to_keep = min_tokens_to_keep
        self.rand_top_k = rand_top_k

    def forward(
        self, logits: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Nucleus sample; returns ``(next_probs, next_tokens)`` each (…, 1)."""
        probs, topk_indices = _top_p_filter(
            logits, self.top_p, self.min_tokens_to_keep, self.rand_top_k, self.filter_value)
        select = sample_from_probs(probs, generator)
        return torch.gather(probs, -1, select), torch.gather(topk_indices, -1, select)

    def extra_repr(self) -> str:
        return (
            f"top_p={self.top_p}, filter_value={self.filter_value}, "
            f"min_tokens_to_keep={self.min_tokens_to_keep}, rand_top_k={self.rand_top_k}"
        )


class MojoTopPFilter(MojoOperator):
    def __init__(self, filter_value: float = -float("inf")):
        super().__init__()
        self.filter_value = filter_value

    def forward(
        self, logits: torch.Tensor, top_p: float, min_tokens_to_keep: int, rand_top_k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(final_probs_dist, sorted_topk_indices)`` each (…, K)."""
        probs, topk_indices = _top_p_filter(logits, top_p, min_tokens_to_keep, rand_top_k, self.filter_value)
        return probs.to(logits.dtype), topk_indices

    def extra_repr(self) -> str:
        return f"filter_value={self.filter_value}"


def _picked(target_probs: torch.Tensor, draft_tokens: torch.Tensor) -> torch.Tensor:
    """target_probs[b, s, draft_tokens[b, s]] for s < S: (B, S)."""
    spec_step = draft_tokens.shape[1]
    return torch.gather(target_probs[:, :spec_step], -1, draft_tokens.long()[..., None])[..., 0]


def _with_sentinel(draft_tokens: torch.Tensor) -> torch.Tensor:
    return torch.cat([draft_tokens, torch.zeros_like(draft_tokens[:, :1])], dim=-1)


def reject_sampling_from_uniform(target_probs, draft_tokens, draft_probs, u):
    """:class:`MojoRejectSampling` with its uniforms ``u`` (B, 1) given:
    accept step i while ``target_p_i / draft_p_i >= u``; a sentinel reject
    after the last step makes the argmax the accepted length."""
    reject = (_picked(target_probs, draft_tokens) / draft_probs) < u
    reject = torch.cat([reject, torch.ones_like(reject[:, :1])], dim=1).int()
    return _with_sentinel(draft_tokens), torch.argmax(reject, dim=1)


def join_prob_reject_from_uniform(target_probs, draft_tokens, draft_probs, u):
    """:class:`MojoJoinProbRejectSampling` with its uniforms ``u`` (B, S)
    given: accept the longest prefix whose cumulative ratio product stays
    at or above the cumulative product of the uniforms."""
    spec_step = draft_probs.shape[1]
    pi = torch.cumprod((_picked(target_probs, draft_tokens) / draft_probs).clamp(0.0, 1.0), dim=1)
    reject = torch.cat([torch.zeros_like(pi[:, :1], dtype=torch.int32), (pi < torch.cumprod(u, dim=1)).int()], dim=1)
    accepted = spec_step - torch.argmin(torch.flip(reject, dims=[1]), dim=1)
    return _with_sentinel(draft_tokens), accepted.int()


class MojoRejectSampling(MojoOperator):
    def forward(
        self,
        target_probs: torch.Tensor,  # (B, S+1, V)
        draft_tokens: torch.Tensor,  # (B, S)
        draft_probs: torch.Tensor,  # (B, S)
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Speculative acceptance with one u ~ U(0, 1) per batch row;
        returns ``(next_tokens (B, S+1), accepted_len (B,))``."""
        u = uniform((target_probs.shape[0], 1), target_probs.device, generator)
        return reject_sampling_from_uniform(target_probs, draft_tokens, draft_probs, u)


class MojoJoinProbRejectSampling(MojoOperator):
    def forward(
        self,
        target_probs: torch.Tensor,
        draft_tokens: torch.Tensor,
        draft_probs: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Joint-probability speculative acceptance via cumulative ratios."""
        u = uniform(tuple(draft_probs.shape), target_probs.device, generator)
        return join_prob_reject_from_uniform(target_probs, draft_tokens, draft_probs, u)


class MojoApplyPenaltiesTempurate(MojoOperator):
    def forward(
        self,
        logits: torch.Tensor,
        token_freqs: List[Union[None, torch.Tensor]],
        presence_penalties: List[float],
        frequency_penalties: List[float],
        repetition_penalties: List[float],
        temps: Optional[List[Optional[float]]] = None,
    ) -> torch.Tensor:
        """Presence / frequency / repetition penalties and temperature per
        batch row; the per-row settings are host values."""
        dtype = logits.dtype
        logits = logits.float()
        rows = []
        for i, freq in enumerate(token_freqs):
            row = logits[i]
            if freq is not None:
                freq = torch.as_tensor(freq, dtype=torch.float32, device=logits.device)
                if frequency_penalties[i] != 0.0:
                    row = row - frequency_penalties[i] * freq
                if presence_penalties[i] != 0.0:
                    row = row - presence_penalties[i] * (freq > 0).float()
                if repetition_penalties[i] != 1.0:
                    conds = row * freq
                    row = torch.where(conds < 0, row * repetition_penalties[i],
                                      torch.where(conds > 0, row / repetition_penalties[i], row))
            if temps is not None and temps[i] is not None:
                row = row / temps[i]
            rows.append(row)
        return torch.stack(rows, dim=0).to(dtype)
