"""Kernel J: trainable varlen GQA/SWA flash attention (``csrc/flash_swa.cu``),
forward, dq and dk/dv, and their plain PyTorch versions.

Replaces the JAX package's ``backends/pallas/kernels/flash_vjp.py:462``
(``flash_swa``; its three ``pallas_call``s at :337, :402 and :436). The
contract is JAX's: packed q (Tq, Hq, D), k/v (Tk, Hkv, D), int32
``cu_q``/``cu_k`` of B + 1. Row t belongs to the last sequence b with
``cu[b] <= t`` (clamped to [0, B - 1]); its absolute position is
``q_abs = kv_len[b] - q_len[b] + (t - cu_q[b])`` and key j's is
``k_pos = j - cu_k[b]``. A row sees the keys of its own sequence, and when
causal those with ``k_pos <= q_abs`` and, if a window is set,
``q_abs <= k_pos + local`` or ``k_pos < global``. The forward keeps the
fp32 log-sum-exp ``lse`` (Tq, Hq) for the backward; a row that sees no key
gives ``o = 0`` and ``lse = EMPTY_LSE``, so its p, and its gradients, are
exactly 0. The backward recomputes ``p = exp(s - lse)`` (FlashAttention-2):
``delta = rowsum(do * o)``, ``ds = p * (dp - delta)``.

GQA: q head h reads kv head ``h // group`` (``AABB``) or ``h % Hkv``
(``ABAB``), any group (the kernels take a group over 64 in chunks). CPU
tensors take the plain versions; CUDA tensors the kernels (``launches``,
``launches_dq``, ``launches_dkv`` count them), which raise on what they do
not take: no fallback. A head_dim that is a multiple of 16 up to 256
(``paged_decode.takes_head_dim``) and not one of ``HEAD_DIMS`` runs at the
next of them: the wrappers zero-pad q, k, v, o and do to that width (a
copy; the kernels are bound by operations) and return the first head_dim
columns of o, dq, dk and dv.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels.paged_decode import padded_head_dim, takes_head_dim
from mojo_opset_tpu_torch.core.operators.attention import GQA_LAYOUTS, expand_gqa, window_mask_rows

launches = 0  # the forward kernel
launches_dq = 0
launches_dkv = 0

EMPTY_LSE = 1e30  # lse of a row that sees no key: exp(s - 1e30) == 0 (JAX flash_vjp.py:44)
HEAD_DIMS = (64, 128, 256)  # the widths the kernels are instantiated at


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def sequence_masks(q, k, cu_q, cu_k, causal, local_window, global_window):
    """Yield ``(q0, q1, k0, k1, keep)`` per sequence: its rows, its keys and
    the (q1 - q0, k1 - k0) keep-mask. Rows and keys are assigned as the
    kernel assigns them (the last b with cu[b] <= t, clamped), so rows past
    ``cu[B]`` fall in the last sequence, as in JAX."""
    cq, ck = cu_q.tolist(), cu_k.tolist()
    B, Tq, Tk = len(cq) - 1, q.shape[0], k.shape[0]
    for b in range(B):
        q0, q1 = (0 if b == 0 else cq[b]), (Tq if b == B - 1 else cq[b + 1])
        k0, k1 = (0 if b == 0 else ck[b]), (Tk if b == B - 1 else ck[b + 1])
        if q1 <= q0 or k1 <= k0:
            continue
        q_abs = torch.arange(q0, q1, device=q.device) + (ck[b + 1] - ck[b]) - (cq[b + 1] - cq[b]) - cq[b]
        k_pos = torch.arange(k0, k1, device=q.device) - ck[b]
        if causal:
            keep = window_mask_rows(q_abs, k_pos, local_window, global_window)
        else:
            keep = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=q.device)
        yield q0, q1, k0, k1, keep


def _heads(kv: torch.Tensor, group: int, gqa_layout: str) -> torch.Tensor:
    """k or v rows (n, Hkv, D) as fp32 (n, Hq, D), each q head's kv head."""
    return expand_gqa(kv.float(), group, gqa_layout, 1)


def _group_sum(x: torch.Tensor, hkv: int, gqa_layout: str) -> torch.Tensor:
    """(n, Hq, D) per-q-head gradients summed onto their kv heads (n, Hkv, D)."""
    n, hq, d = x.shape
    if gqa_layout == "AABB":
        return x.reshape(n, hkv, hq // hkv, d).sum(2)
    return x.reshape(n, hq // hkv, hkv, d).sum(1)


def _probs(qb, kb, keep, lse_b):
    """p = exp(s - lse) on the kept pairs, (Hq, n_q, n_k) fp32; qb carries the scale."""
    s = torch.einsum("qhd,khd->hqk", qb, kb)
    return torch.where(keep[None], torch.exp(s - lse_b.t()[:, :, None]), 0.0)


def flash_swa_fwd_plain(q, k, v, cu_q, cu_k, causal=True, local_window=None, global_window=None, scale=None,
                        gqa_layout="AABB"):
    """The forward in plain PyTorch, one sequence at a time: ``(o, lse)``,
    o in q's dtype, lse (Tq, Hq) fp32."""
    Tq, Hq, _ = q.shape
    group = Hq // k.shape[1]
    scale = _scale(q, scale)
    o = torch.zeros_like(q)
    lse = torch.full((Tq, Hq), EMPTY_LSE, dtype=torch.float32, device=q.device)
    for q0, q1, k0, k1, keep in sequence_masks(q, k, cu_q, cu_k, causal, local_window, global_window):
        s = torch.einsum("qhd,khd->hqk", q[q0:q1].float() * scale, _heads(k[k0:k1], group, gqa_layout))
        row_lse = torch.logsumexp(s.masked_fill(~keep[None], float("-inf")), dim=-1)  # (Hq, n_q); -inf: no key
        seen = torch.isfinite(row_lse)
        p = torch.where(keep[None] & seen[:, :, None], torch.exp(s - row_lse[:, :, None]), 0.0)
        o[q0:q1] = torch.einsum("hqk,khd->qhd", p, _heads(v[k0:k1], group, gqa_layout)).to(q.dtype)
        lse[q0:q1] = torch.where(seen, row_lse, EMPTY_LSE).t()
    return o, lse


def flash_swa_dq_plain(q, k, v, o, do, lse, cu_q, cu_k, causal=True, local_window=None, global_window=None,
                       scale=None, gqa_layout="AABB"):
    """dq by the recompute formulas, and ``delta = rowsum(do * o)`` (Tq, Hq)
    fp32, which the dk/dv pass reads: ``(dq, delta)``."""
    group = q.shape[1] // k.shape[1]
    scale = _scale(q, scale)
    delta = (do.float() * o.float()).sum(-1)
    dq = torch.zeros_like(q)
    for q0, q1, k0, k1, keep in sequence_masks(q, k, cu_q, cu_k, causal, local_window, global_window):
        kb = _heads(k[k0:k1], group, gqa_layout)
        p = _probs(q[q0:q1].float() * scale, kb, keep, lse[q0:q1])
        dp = torch.einsum("qhd,khd->hqk", do[q0:q1].float(), _heads(v[k0:k1], group, gqa_layout))
        ds = p * (dp - delta[q0:q1].t()[:, :, None])
        dq[q0:q1] = (scale * torch.einsum("hqk,khd->qhd", ds, kb)).to(q.dtype)
    return dq, delta


def flash_swa_dkv_plain(q, k, v, do, lse, delta, cu_q, cu_k, causal=True, local_window=None, global_window=None,
                        scale=None, gqa_layout="AABB"):
    """dk and dv by the recompute formulas, each q head's share summed onto
    its kv head (the GQA group reduction): ``(dk, dv)``."""
    hkv = k.shape[1]
    group = q.shape[1] // hkv
    scale = _scale(q, scale)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0, q1, k0, k1, keep in sequence_masks(q, k, cu_q, cu_k, causal, local_window, global_window):
        qb = q[q0:q1].float() * scale
        dob = do[q0:q1].float()
        p = _probs(qb, _heads(k[k0:k1], group, gqa_layout), keep, lse[q0:q1])
        dp = torch.einsum("qhd,khd->hqk", dob, _heads(v[k0:k1], group, gqa_layout))
        ds = p * (dp - delta[q0:q1].t()[:, :, None])
        dv[k0:k1] = _group_sum(torch.einsum("hqk,qhd->khd", p, dob), hkv, gqa_layout).to(v.dtype)
        dk[k0:k1] = _group_sum(torch.einsum("hqk,qhd->khd", ds, qb), hkv, gqa_layout).to(k.dtype)  # qb holds the scale
    return dk, dv


def flash_swa_bwd_plain(q, k, v, o, lse, do, cu_q, cu_k, **cfg):
    """The backward in plain PyTorch: ``(dq, dk, dv)``."""
    dq, delta = flash_swa_dq_plain(q, k, v, o, do, lse, cu_q, cu_k, **cfg)
    dk, dv = flash_swa_dkv_plain(q, k, v, do, lse, delta, cu_q, cu_k, **cfg)
    return dq, dk, dv


# -- the kernels ---------------------------------------------------------------


def _check(q, k, v, cu_q, cu_k, local_window, global_window, gqa_layout, *rows):
    """Input checks of the three entry points; ``rows`` are further
    (Tq, Hq, D) tensors (o, do). Returns the launch's integer arguments."""
    code = build.dtype_code(q)
    build.require(q.ndim == 3 and k.ndim == 3 and v.shape == k.shape,
                  f"q must be (Tq, Hq, D) and k, v one (Tk, Hkv, D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                  f"{tuple(v.shape)}")
    Tq, Hq, D = q.shape
    Tk, Hkv, _ = k.shape
    build.require(takes_head_dim(D) and k.shape[2] == D,
                  f"flash_swa takes a head_dim that is a multiple of 16 up to {HEAD_DIMS[-1]}, got {D}")
    build.require(Hq % Hkv == 0, f"flash_swa takes Hq a multiple of Hkv, got {Hq}/{Hkv}")
    build.require(gqa_layout in GQA_LAYOUTS, f"gqa_layout must be one of {GQA_LAYOUTS}, got {gqa_layout}")
    for window in (local_window, global_window):
        build.require(window is None or window >= 0, f"windows are None or >= 0, got {window}")
    for t in (k, v, *rows):
        build.require(t.dtype == q.dtype, f"q, k, v, o and do must share one dtype, got {q.dtype} and {t.dtype}")
    for t in rows:
        build.require(t.shape == q.shape, f"o and do must have q's shape {tuple(q.shape)}, got {tuple(t.shape)}")
    for t in (q, k, v, *rows):
        build.require(t.is_contiguous() and t.data_ptr() % 16 == 0, "flash_swa takes contiguous 16-byte aligned rows")
    build.require_device(q.device, k, v, cu_q, cu_k, *rows)
    B = cu_q.shape[0] - 1
    for name, cu in (("cu_q", cu_q), ("cu_k", cu_k)):
        build.require(cu.dtype == torch.int32 and cu.shape == (B + 1,) and cu.is_contiguous() and B >= 1,
                      f"{name} must be contiguous int32 (B + 1,) with B >= 1, both of one B; got {cu.dtype} "
                      f"{tuple(cu.shape)}")
    lws = -1 if local_window is None else int(local_window)
    gws = -1 if global_window is None else int(global_window)
    return B, Tq, Tk, Hq, Hkv, padded_head_dim(D), lws, gws, int(gqa_layout == "ABAB"), code


def _tail(args, scale, causal):
    """The scalar arguments every entry point ends with: B, Tq, Tk, hq, hkv,
    D (the padded width), scale, causal, lws, gws, abab, dtype."""
    B, Tq, Tk, Hq, Hkv, D, lws, gws, abab, code = args
    return (B, Tq, Tk, Hq, Hkv, D, float(scale), int(bool(causal)), lws, gws, abab, code)


def pad_head_dim(width: int, *tensors):
    """The tensors zero-padded on their last dim to ``width`` (unchanged
    when they have it)."""
    return tuple(t if t.shape[-1] == width else torch.nn.functional.pad(t, (0, width - t.shape[-1]))
                 for t in tensors)


def narrow_head_dim(width: int, *tensors):
    """The first ``width`` columns of each tensor's last dim, contiguous."""
    return tuple(t if t.shape[-1] == width else t[..., :width].contiguous() for t in tensors)


def flash_swa_fwd(q, k, v, cu_q, cu_k, causal=True, local_window=None, global_window=None, scale=None,
                  gqa_layout="AABB"):
    """The forward: ``(o, lse)``. A CPU tensor takes the plain version; a
    CUDA tensor the kernel."""
    if q.device.type == "cpu":
        return flash_swa_fwd_plain(q, k, v, cu_q, cu_k, causal, local_window, global_window, scale, gqa_layout)
    global launches
    args = _check(q, k, v, cu_q, cu_k, local_window, global_window, gqa_layout)
    scale, d = _scale(q, scale), q.shape[-1]
    q, k, v = pad_head_dim(args[5], q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if q.shape[0] > 0:
        build.launch("mojo_flash_swa_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), cu_q.data_ptr(),
                     cu_k.data_ptr(), o.data_ptr(), lse.data_ptr(), *_tail(args, scale, causal))
        launches += 1
    return narrow_head_dim(d, o)[0], lse


def flash_swa_dq(q, k, v, o, do, lse, cu_q, cu_k, causal=True, local_window=None, global_window=None, scale=None,
                 gqa_layout="AABB"):
    """dq and ``delta``: ``(dq, delta)``; plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_swa_dq_plain(q, k, v, o, do, lse, cu_q, cu_k, causal, local_window, global_window, scale,
                                  gqa_layout)
    global launches_dq
    args = _check(q, k, v, cu_q, cu_k, local_window, global_window, gqa_layout, o, do)
    _check_rowstats(q, lse)
    scale, d = _scale(q, scale), q.shape[-1]
    q, k, v, o, do = pad_head_dim(args[5], q, k, v, o, do)
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if q.shape[0] > 0:
        build.launch("mojo_flash_swa_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), cu_q.data_ptr(), cu_k.data_ptr(), dq.data_ptr(), delta.data_ptr(),
                     *_tail(args, scale, causal))
        launches_dq += 1
    return narrow_head_dim(d, dq)[0], delta


def flash_swa_dkv(q, k, v, do, lse, delta, cu_q, cu_k, causal=True, local_window=None, global_window=None,
                  scale=None, gqa_layout="AABB"):
    """dk and dv, written once per kv head in k's dtype: ``(dk, dv)``;
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_swa_dkv_plain(q, k, v, do, lse, delta, cu_q, cu_k, causal, local_window, global_window, scale,
                                   gqa_layout)
    global launches_dkv
    args = _check(q, k, v, cu_q, cu_k, local_window, global_window, gqa_layout, do)
    _check_rowstats(q, lse, delta)
    scale, d = _scale(q, scale), q.shape[-1]
    q, k, v, do = pad_head_dim(args[5], q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.shape[0] > 0:
        build.launch("mojo_flash_swa_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), cu_q.data_ptr(), cu_k.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     *_tail(args, scale, causal))
        launches_dkv += 1
    return narrow_head_dim(d, dk, dv)


def _check_rowstats(q, *stats):
    for t in stats:
        build.require(t.dtype == torch.float32 and t.shape == q.shape[:2] and t.is_contiguous(),
                      f"lse and delta must be contiguous float32 (Tq, Hq), got {t.dtype} {tuple(t.shape)}")
        build.require_device(q.device, t)


def flash_swa_bwd(q, k, v, o, lse, do, cu_q, cu_k, **cfg):
    """The backward, dq then dk/dv (the second reads the first's delta):
    ``(dq, dk, dv)``."""
    dq, delta = flash_swa_dq(q, k, v, o, do, lse, cu_q, cu_k, **cfg)
    dk, dv = flash_swa_dkv(q, k, v, do, lse, delta, cu_q, cu_k, **cfg)
    return dq, dk, dv
