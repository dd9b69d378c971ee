"""Kernel O: dense attention under an arbitrary boolean keep-mask
(``csrc/flash_diffusion.cu``), forward, dq and dk/dv, and their plain
PyTorch versions.

Replaces the JAX package's ``backends/pallas/kernels/diffusion_vjp.py:289``
(``flash_diffusion``; its three ``pallas_call``s at :179, :227 and :252).
The contract is JAX's, widened: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) with
``Hq % Hkv == 0`` (query head h reads kv head ``h // group``, ``AABB``),
and a bool keep-mask that broadcasts to (B, Hq, Sq, Sk): JAX's (S, S), the
Wan DiT's (B, 1, 1, S) key padding, or a full mask. The kernel reads the
mask through the strides of that broadcast view (0 on every broadcast
axis), so it is never materialized, and reads it transposed in dk/dv by
swapping two strides.

The forward keeps the fp32 log-sum-exp ``lse`` (B, Hq, Sq). A row whose
mask keeps no key gets ``lse = EMPTY_LSE``, so ``exp(s - lse)`` is exactly
0 in the backward, and ``o = empty``: 0 for the training Function (JAX's
definition, diffusion_vjp.py:35), NaN for ``CudaSdpa`` (the golden
softmax's). Its dq is 0 and it adds nothing to dk/dv. The backward
recomputes ``p = exp(s - lse)`` (FlashAttention-2): ``delta =
rowsum(do * o)``, ``ds = p * (dp - delta)`` on the kept pairs.

CPU tensors take the plain versions; CUDA tensors the kernels
(``launches``, ``launches_dq``, ``launches_dkv`` count them), which raise
on what they do not take: no fallback. A head_dim that is a multiple of 16
up to 256 and not one of ``HEAD_DIMS`` runs at the next of them, q, k, v,
o and do zero-padded by the wrappers, as kernel J's
(``flash_swa.pad_head_dim``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels.flash_swa import narrow_head_dim, pad_head_dim
from mojo_opset_tpu_torch.backends.cuda.kernels.paged_decode import padded_head_dim, takes_head_dim

launches = 0  # the forward kernel
launches_dq = 0
launches_dkv = 0

EMPTY_LSE = 1e30  # lse of a row whose mask keeps no key (JAX diffusion_vjp.py:35)
HEAD_DIMS = (64, 128, 256)  # the widths the kernels are instantiated at


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def keep_mask(mask: torch.Tensor, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The bool keep-mask as a (B, Hq, Sq, Sk) view (stride 0 on broadcast axes)."""
    if mask.dtype != torch.bool:
        raise ValueError(f"flash_diffusion takes a bool keep-mask, got {mask.dtype}")
    B, Hq, Sq, _ = q.shape
    return mask.expand(B, Hq, Sq, k.shape[2])


def _kv_heads(x: torch.Tensor, group: int) -> torch.Tensor:
    """k or v of one batch row (Hkv, Sk, D) as fp32 (Hq, Sk, D), AABB."""
    return x.float().repeat_interleave(group, dim=0)


def _probs(qb, kb, keep, lse_b):
    """p = exp(s - lse) on the kept pairs, (Hq, Sq, Sk) fp32; qb carries the scale."""
    s = torch.einsum("hqd,hkd->hqk", qb, kb)
    return torch.where(keep, torch.exp(s - lse_b[:, :, None]), 0.0)


def flash_diffusion_fwd_plain(q, k, v, mask, scale=None, empty=0.0):
    """The forward in plain PyTorch, one batch row at a time: ``(o, lse)``,
    o in q's dtype (``empty`` on rows that keep no key), lse (B, Hq, Sq) fp32."""
    group = q.shape[1] // k.shape[1]
    scale = _scale(q, scale)
    keep = keep_mask(mask, q, k)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    for b in range(q.shape[0]):
        s = torch.einsum("hqd,hkd->hqk", q[b].float() * scale, _kv_heads(k[b], group))
        row_lse = torch.logsumexp(s.masked_fill(~keep[b], float("-inf")), dim=-1)  # -inf: no key kept
        seen = torch.isfinite(row_lse)
        p = torch.where(keep[b] & seen[:, :, None], torch.exp(s - row_lse[:, :, None]), 0.0)
        ob = torch.einsum("hqk,hkd->hqd", p, _kv_heads(v[b], group))
        o[b] = torch.where(seen[:, :, None], ob, empty).to(q.dtype)
        lse[b] = torch.where(seen, row_lse, EMPTY_LSE)
    return o, lse


def _ds(p, dp, delta_b, keep_b):
    """ds = p * (dp - delta) on the kept pairs, 0 elsewhere (a NaN row of o
    has no kept pair)."""
    return torch.where(keep_b, p * (dp - delta_b[:, :, None]), 0.0)


def flash_diffusion_dq_plain(q, k, v, o, do, lse, mask, scale=None):
    """dq by the recompute formulas, and ``delta = rowsum(do * o)``
    (B, Hq, Sq) fp32, which the dk/dv pass reads: ``(dq, delta)``."""
    group = q.shape[1] // k.shape[1]
    scale = _scale(q, scale)
    keep = keep_mask(mask, q, k)
    delta = (do.float() * o.float()).sum(-1)
    dq = torch.empty_like(q)
    for b in range(q.shape[0]):
        kb = _kv_heads(k[b], group)
        p = _probs(q[b].float() * scale, kb, keep[b], lse[b])
        dp = torch.einsum("hqd,hkd->hqk", do[b].float(), _kv_heads(v[b], group))
        dq[b] = (scale * torch.einsum("hqk,hkd->hqd", _ds(p, dp, delta[b], keep[b]), kb)).to(q.dtype)
    return dq, delta


def flash_diffusion_dkv_plain(q, k, v, do, lse, delta, mask, scale=None):
    """dk and dv by the recompute formulas, each q head's share summed onto
    its kv head (the GQA group reduction): ``(dk, dv)``."""
    hkv = k.shape[1]
    group = q.shape[1] // hkv
    scale = _scale(q, scale)
    keep = keep_mask(mask, q, k)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for b in range(q.shape[0]):
        qb, dob = q[b].float() * scale, do[b].float()
        p = _probs(qb, _kv_heads(k[b], group), keep[b], lse[b])
        dp = torch.einsum("hqd,hkd->hqk", dob, _kv_heads(v[b], group))
        ds = _ds(p, dp, delta[b], keep[b])
        dv_h = torch.einsum("hqk,hqd->hkd", p, dob)
        dk_h = torch.einsum("hqk,hqd->hkd", ds, qb)  # qb holds the scale
        dv[b] = dv_h.reshape(hkv, group, *dv_h.shape[1:]).sum(1).to(v.dtype)
        dk[b] = dk_h.reshape(hkv, group, *dk_h.shape[1:]).sum(1).to(k.dtype)
    return dk, dv


# -- the kernels ---------------------------------------------------------------


def _check(q, k, v, mask, *rows):
    """Input checks of the three entry points; ``rows`` are further
    (B, Hq, Sq, D) tensors (o, do). Returns the mask view and the launch's
    integer arguments."""
    code = build.dtype_code(q)
    build.require(q.ndim == 4 and k.ndim == 4 and v.shape == k.shape and k.shape[0] == q.shape[0],
                  f"q must be (B, Hq, Sq, D) and k, v one (B, Hkv, Sk, D), got {tuple(q.shape)}, "
                  f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    build.require(takes_head_dim(D) and k.shape[3] == D,
                  f"flash_diffusion takes a head_dim that is a multiple of 16 up to {HEAD_DIMS[-1]}, got {D}")
    build.require(Hkv >= 1 and Hq % Hkv == 0, f"flash_diffusion takes Hq a multiple of Hkv, got {Hq}/{Hkv}")
    for t in (k, v, *rows):
        build.require(t.dtype == q.dtype, f"q, k, v, o and do must share one dtype, got {q.dtype} and {t.dtype}")
    for t in rows:
        build.require(t.shape == q.shape, f"o and do must have q's shape {tuple(q.shape)}, got {tuple(t.shape)}")
    for t in (q, k, v, *rows):
        build.require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                      "flash_diffusion takes contiguous 16-byte aligned tensors")
    keep = keep_mask(mask, q, k)
    build.require_device(q.device, k, v, keep, *rows)
    return keep, (B, Hq, Hkv, Sq, Sk, padded_head_dim(D), *keep.stride())


def _check_rowstats(q, *stats):
    for t in stats:
        build.require(t.dtype == torch.float32 and t.shape == q.shape[:3] and t.is_contiguous(),
                      f"lse and delta must be contiguous float32 (B, Hq, Sq), got {t.dtype} {tuple(t.shape)}")
        build.require_device(q.device, t)


def flash_diffusion_fwd(q, k, v, mask, scale=None, empty=0.0):
    """The forward: ``(o, lse)``. A CPU tensor takes the plain version; a
    CUDA tensor the kernel."""
    if q.device.type == "cpu":
        return flash_diffusion_fwd_plain(q, k, v, mask, scale, empty)
    global launches
    build.require_no_grad("flash_diffusion_fwd", q, k, v)
    keep, args = _check(q, k, v, mask)
    scale, d = _scale(q, scale), q.shape[-1]
    q, k, v = pad_head_dim(args[5], q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if o.numel() > 0:
        build.launch("mojo_flash_diffusion_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     keep.data_ptr(), o.data_ptr(), lse.data_ptr(), *args, scale, float(empty),
                     build.dtype_code(q))
        launches += 1
    return narrow_head_dim(d, o)[0], lse


def flash_diffusion_dq(q, k, v, o, do, lse, mask, scale=None):
    """dq and ``delta``: ``(dq, delta)``; plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_diffusion_dq_plain(q, k, v, o, do, lse, mask, scale)
    global launches_dq
    build.require_no_grad("flash_diffusion_dq", q, k, v, o, do)
    keep, args = _check(q, k, v, mask, o, do)
    _check_rowstats(q, lse)
    scale, d = _scale(q, scale), q.shape[-1]
    q, k, v, o, do = pad_head_dim(args[5], q, k, v, o, do)
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if dq.numel() > 0:
        build.launch("mojo_flash_diffusion_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), keep.data_ptr(), dq.data_ptr(), delta.data_ptr(), *args,
                     scale, build.dtype_code(q))
        launches_dq += 1
    return narrow_head_dim(d, dq)[0], delta


def flash_diffusion_dkv(q, k, v, do, lse, delta, mask, scale=None):
    """dk and dv, written once per kv head in k's dtype: ``(dk, dv)``;
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_diffusion_dkv_plain(q, k, v, do, lse, delta, mask, scale)
    global launches_dkv
    build.require_no_grad("flash_diffusion_dkv", q, k, v, do)
    keep, args = _check(q, k, v, mask, do)
    _check_rowstats(q, lse, delta)
    scale, d = _scale(q, scale), q.shape[-1]
    q, k, v, do = pad_head_dim(args[5], q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() > 0:
        build.launch("mojo_flash_diffusion_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(), keep.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), *args, scale, build.dtype_code(q))
        launches_dkv += 1
    return narrow_head_dim(d, dk, dv)


def flash_diffusion_bwd(q, k, v, o, lse, do, mask, scale=None):
    """The backward, dq then dk/dv (the second reads the first's delta):
    ``(dq, dk, dv)``."""
    dq, delta = flash_diffusion_dq(q, k, v, o, do, lse, mask, scale)
    dk, dv = flash_diffusion_dkv(q, k, v, do, lse, delta, mask, scale)
    return dq, dk, dv


def flash_diffusion_bwd_plain(q, k, v, o, lse, do, mask, scale=None):
    """The backward in plain PyTorch: ``(dq, dk, dv)``."""
    dq, delta = flash_diffusion_dq_plain(q, k, v, o, do, lse, mask, scale)
    dk, dv = flash_diffusion_dkv_plain(q, k, v, do, lse, delta, mask, scale)
    return dq, dk, dv
