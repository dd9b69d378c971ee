"""Kernel N: fused linear + cross-entropy (``csrc/flce.cu``), its plain
PyTorch versions, and the plain assembly around it.

Replaces the JAX package's ``backends/pallas/kernels/flce.py:324``
(``flce``: the statistics kernel, call :120; the dx and dw kernels, calls
:241 and :266). Four entry points, each with its counter:

- ``flce_stats`` (``launches``): per row ``(lse, target logit, zsum)`` of
  ``z = x w^T`` in fp32 (softcapped when asked), over the columns ``< V``;
- ``flce_dz`` (``launches_dz``): ``dz`` of a run of rows in x's dtype,
  recomputing z;
- ``flce_dx`` (``launches_dx``): ``dx = dz w`` in x's dtype;
- ``flce_dw`` (``launches_dw``): ``dw = dz^T x`` in w's dtype, or added into
  an fp32 buffer across runs.

``flce_backward`` composes the last three over runs of rows whose ``dz``
fits ``dz_budget`` bytes (``DZ_BUDGET_BYTES`` by default: Qwen3-4B's 4096 x
151936 bf16 dz, 1.16 GiB, is one run); dw then adds across runs in a fixed
order. No logits are kept between the forward and the backward: the
autograd Function saves x, w, target and lse (JAX :350-355).
``loss_from_stats`` (JAX :303-320) and ``backward_coefficients`` (JAX
:358-372) are plain tensor math, as they are in JAX.

A target outside ``[0, V)`` finds no target logit (0) and gives its dz no
one-hot term, in both versions: a vocab-parallel loss passes the targets
shifted by its shard's first row, so each rank reads the targets its rows
hold. ``vocab_size`` (the dz's and the backward's) is the vocabulary the
label smoothing spreads over, ``w.shape[0]`` unless a shard's ``w`` holds
part of it (``core.functions.loss.combine_row_stats`` merges the shards'
statistics over their group: plain torch around N).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mojo_opset_tpu_torch.backends.cuda import build

launches = 0
launches_dz = 0
launches_dx = 0
launches_dw = 0

DZ_BUDGET_BYTES = 2**31  # the largest dz of one run
DX_TILE = (128, 256)  # kernel N's output tile (rows, columns) on the tensor cores
DX_MIN_STAGES = 16  # the fewest 64-deep stages of one K range of dx
MAX_SPLITS = 2 * 132  # vocab splits of the statistics pass: at most two blocks a streaming multiprocessor
_LD_ALIGN = 8  # dz's row pitch, in elements: 16-byte rows for 16-bit types


def _check_softcap(softcap: Optional[float]) -> float:
    build.require(softcap is None or softcap > 0, f"flce: softcap must be None or > 0, got {softcap}")
    return 0.0 if softcap is None else float(softcap)


def _capped(z: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    return z if softcap is None else torch.tanh(z / softcap) * softcap


def _logits(x: torch.Tensor, w: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    return _capped(x.float() @ w.float().t(), softcap)


def _in_vocab(target: torch.Tensor, V: int) -> torch.Tensor:
    return (target >= 0) & (target < V)


def _spread(label_smoothing: float, vocab_size: int) -> float:
    """``s / Vs`` rounded once to fp32, as the kernel computed it before taking it from the caller."""
    return float(np.float32(label_smoothing) / np.float32(vocab_size))


def flce_stats_plain(x: torch.Tensor, w: torch.Tensor, target: torch.Tensor, softcap: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(lse, target logit, zsum)``, (N,) fp32 each, from z in fp32."""
    V = w.shape[0]
    z = _logits(x, w, softcap)
    hit = _in_vocab(target, V)
    tl = torch.where(hit, z.gather(1, torch.where(hit, target, 0).long()[:, None])[:, 0], 0.0)
    return torch.logsumexp(z, dim=1), tl, z.sum(1)


def flce_dz_plain(x, w, target, lse, a, c, softcap=None, label_smoothing=0.0, vocab_size=None) -> torch.Tensor:
    """``dz = p a - c ((1 - s) onehot + s / Vs)``, times ``1 - (zc / cap)^2``
    under a softcap, in x's dtype: (N, V); ``Vs`` is ``vocab_size``, V by default."""
    V = w.shape[0]
    zc = _logits(x, w, softcap)
    p = torch.exp(zc - lse[:, None])
    onehot = torch.zeros_like(zc)
    hit = _in_vocab(target, V)
    onehot[hit, target[hit].long()] = 1.0
    dz = p * a[:, None] - c[:, None] * ((1.0 - label_smoothing) * onehot + label_smoothing / (vocab_size or V))
    if softcap is not None:
        dz = dz * (1.0 - (zc / softcap) ** 2)
    return dz.to(x.dtype)


def flce_dx_plain(dz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (dz.float() @ w.float()).to(dz.dtype)


def flce_dw_plain(dz: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (dz.float().t() @ x.float()).to(x.dtype)


def flce_backward_plain(x, w, target, lse, a, c, softcap=None, label_smoothing=0.0, need_dx=True, need_dw=True,
                        vocab_size=None) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(dx, dw)`` through the plain dz, in one run."""
    dz = flce_dz_plain(x, w, target, lse, a, c, softcap, label_smoothing, vocab_size)
    return (flce_dx_plain(dz, w) if need_dx else None), (flce_dw_plain(dz, x).to(w.dtype) if need_dw else None)


def loss_from_stats(lse, tl, zs, target, V: int, ignore_index: int, lse_square_scale: float,
                    label_smoothing: float, reduction: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, z_loss)`` from the per-row statistics, ``mean`` or ``sum``."""
    valid = target != ignore_index
    s = label_smoothing
    nll = torch.where(valid, (1.0 - s) * (lse - tl) + s * (lse - zs / V), 0.0)
    n_valid = valid.sum().clamp(min=1).float()
    loss = nll.sum() / n_valid if reduction == "mean" else nll.sum()
    z_loss = torch.zeros((), dtype=torch.float32, device=lse.device)
    if lse_square_scale > 0.0:
        lse_v = torch.where(valid, lse, 0.0)
        z_sum = lse_square_scale * (lse_v * lse_v).sum()
        z_loss = z_sum / n_valid if reduction == "mean" else z_sum
        loss = loss + z_loss
    return loss, z_loss


def backward_coefficients(g_loss, g_z, lse, target, ignore_index: int, lse_square_scale: float, reduction: str
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-row ``(a, c)`` of dz: ``c`` scales the target term, ``a`` the
    softmax (it folds in the z-loss's ``2 alpha lse``)."""
    valid = (target != ignore_index).float()
    scale = 1.0 / valid.sum().clamp(min=1) if reduction == "mean" else 1.0
    c = g_loss.float() * valid * scale
    zc = (g_loss.float() + g_z.float()) * valid * scale
    return (c + 2.0 * lse_square_scale * lse * zc).contiguous(), c.contiguous()


def _check_inputs(name, x, w, target):
    build.require(x.ndim == 2 and w.ndim == 2 and x.shape[1] == w.shape[1],
                  f"{name}: x (N, H) and w (V, H) must share H, got {tuple(x.shape)} and {tuple(w.shape)}")
    build.require(target.shape == (x.shape[0],), f"{name}: target must be ({x.shape[0]},), got {tuple(target.shape)}")


def _check_kernel_inputs(name, x, w, target):
    """The kernel's own limits: one dtype, contiguous 16-byte aligned rows."""
    code = build.dtype_code(x)
    build.require(w.dtype == x.dtype, f"{name}: x and w share one dtype, got {x.dtype} and {w.dtype}")
    build.require_device(x.device, w, target)
    width = 16 // x.element_size()
    build.require(x.shape[1] % width == 0, f"{name}: H must be a multiple of {width} for {x.dtype}, "
                                           f"got {x.shape[1]}")
    for label, t in (("x", x), ("w", w)):
        build.require(t.is_contiguous() and t.data_ptr() % 16 == 0, f"{name}: {label} must be contiguous and "
                                                                    f"16-byte aligned")
    build.require(target.dtype == torch.int32 and target.is_contiguous(),
                  f"{name}: target must be contiguous int32, got {target.dtype}")
    return code


def _check_dz(name, dz, V):
    build.require(dz.ndim == 2 and dz.shape[1] == V and dz.stride(1) == 1, f"{name}: dz must be (rows, {V}) with "
                                                                          f"unit column stride")
    width = 16 // dz.element_size()
    build.require(dz.stride(0) % width == 0 and dz.data_ptr() % 16 == 0,
                  f"{name}: dz's row pitch must be a multiple of {width} elements and its rows 16-byte aligned")


def _f32(*tensors):
    for t in tensors:
        build.require(t.dtype == torch.float32 and t.is_contiguous(), "flce: lse, a and c must be contiguous "
                                                                      "float32")


def flce_stats(x: torch.Tensor, w: torch.Tensor, target: torch.Tensor, softcap: Optional[float] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (N, H) and w (V, H) of one dtype, int32 target (N,) -> ``(lse,
    target logit, zsum)``, (N,) fp32 each. A CPU tensor takes the plain
    version; a CUDA tensor the kernel."""
    build.require_no_grad("flce_stats", x, w)
    _check_inputs("flce_stats", x, w, target)
    cap = _check_softcap(softcap)
    if x.device.type == "cpu":
        return flce_stats_plain(x, w, target, softcap)
    global launches
    code = _check_kernel_inputs("flce_stats", x, w, target)
    N, H = x.shape
    V = w.shape[0]
    lse, tl, zs = (torch.empty(N, dtype=torch.float32, device=x.device) for _ in range(3))
    if N == 0:
        return lse, tl, zs
    build.require(V > 0, "flce_stats: w has no rows")
    part = torch.empty(4 * MAX_SPLITS * N, dtype=torch.float32, device=x.device)
    build.launch("mojo_flce_stats", x.device, x.data_ptr(), w.data_ptr(), target.data_ptr(), part.data_ptr(),
                 lse.data_ptr(), tl.data_ptr(), zs.data_ptr(), N, H, V, MAX_SPLITS, cap, code)
    launches += 1
    return lse, tl, zs


def _dz_buffer(rows: int, V: int, like: torch.Tensor) -> torch.Tensor:
    ldz = -(-V // _LD_ALIGN) * _LD_ALIGN
    return torch.empty(rows, ldz, dtype=like.dtype, device=like.device)[:, :V]


def _dz_kernel(x, w, target, lse, a, c, cap, label_smoothing, r0, rows, out, vocab_size=None):
    global launches_dz
    build.launch("mojo_flce_dz", x.device, x.data_ptr(), w.data_ptr(), target.data_ptr(), lse.data_ptr(),
                 a.data_ptr(), c.data_ptr(), out.data_ptr(), r0, rows, x.shape[1], w.shape[0], out.stride(0),
                 cap, float(label_smoothing), _spread(label_smoothing, vocab_size or w.shape[0]), build.dtype_code(x))
    launches_dz += 1
    return out


def flce_dz(x, w, target, lse, a, c, softcap=None, label_smoothing=0.0, vocab_size=None) -> torch.Tensor:
    """``dz`` (N, V) in x's dtype from the saved ``lse`` and the per-row
    ``a``, ``c`` (fp32), the smoothing spread over ``vocab_size`` (V by
    default). A CPU tensor takes the plain version; a CUDA tensor the kernel
    (its rows on a pitch of a multiple of 8 elements)."""
    build.require_no_grad("flce_dz", x, w)
    _check_inputs("flce_dz", x, w, target)
    cap = _check_softcap(softcap)
    if x.device.type == "cpu":
        return flce_dz_plain(x, w, target, lse, a, c, softcap, label_smoothing, vocab_size)
    _check_kernel_inputs("flce_dz", x, w, target)
    _f32(lse, a, c)
    out = _dz_buffer(x.shape[0], w.shape[0], x)
    if x.shape[0] == 0:
        return out
    return _dz_kernel(x, w, target, lse, a, c, cap, label_smoothing, 0, x.shape[0], out, vocab_size)


def dx_splits(rows: int, H: int, V: int, sms: int) -> int:
    """K ranges of dx's product (its K is V): of 1, 2 and 4, the count that
    leaves the fewest waves of full-length tiles on ``sms`` SMs (dx has few
    output tiles: 320 at Qwen3-4B's step, 2.4 waves of 132), each range at
    least ``DX_MIN_STAGES`` stages; a tie keeps the smaller."""
    tiles = -(-rows // DX_TILE[0]) * -(-H // DX_TILE[1])
    stages = -(-V // 64)

    def waves(k):
        return -(-k * tiles // sms) / k

    best = 1
    for k in (2, 4):
        if stages // k >= DX_MIN_STAGES and waves(k) < waves(best):
            best = k
    return best


def _dx_kernel(dz, w, out):
    global launches_dx
    rows, H, V = dz.shape[0], w.shape[1], w.shape[0]
    k_splits = 1 if dz.dtype == torch.float32 else dx_splits(rows, H, V, build.sm_count(dz.device))
    # per K range, its fp32 sums: added in range order by the kernel's second pass; held until the launch is queued
    part = torch.empty(k_splits, rows, H, dtype=torch.float32, device=dz.device) if k_splits > 1 else None
    build.launch("mojo_flce_dx", dz.device, dz.data_ptr(), w.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(), rows, H, V, dz.stride(0), k_splits, build.dtype_code(dz))
    launches_dx += 1
    return out


def flce_dx(dz: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``dx = dz w`` (rows, H) in dz's dtype, fp32 sums. A CPU tensor takes
    the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("flce_dx", dz, w)
    if dz.device.type == "cpu":
        return flce_dx_plain(dz, w)
    _check_dz("flce_dx", dz, w.shape[0])
    build.require(w.dtype == dz.dtype and w.is_contiguous() and w.data_ptr() % 16 == 0,
                  "flce_dx: w must be contiguous, 16-byte aligned and of dz's dtype")
    build.require(w.shape[1] % (16 // w.element_size()) == 0, f"flce_dx: H {w.shape[1]} breaks 16-byte rows")
    build.require_device(dz.device, w)
    out = torch.empty(dz.shape[0], w.shape[1], dtype=dz.dtype, device=dz.device)
    if dz.shape[0] == 0:
        return out
    return _dx_kernel(dz, w, out)


def _dw_kernel(dz, x, out, buf, mode):
    global launches_dw
    build.launch("mojo_flce_dw", dz.device, dz.data_ptr(), x.data_ptr(), out.data_ptr(),
                 None if buf is None else buf.data_ptr(), dz.shape[0], x.shape[1], dz.shape[1], dz.stride(0), mode,
                 build.dtype_code(dz))
    launches_dw += 1


def flce_dw(dz: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``dw = dz^T x`` (V, H) in x's dtype, fp32 sums. A CPU tensor takes
    the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("flce_dw", dz, x)
    if dz.device.type == "cpu":
        return flce_dw_plain(dz, x)
    _check_dz("flce_dw", dz, dz.shape[1])
    build.require(x.dtype == dz.dtype and x.is_contiguous() and x.data_ptr() % 16 == 0,
                  "flce_dw: x must be contiguous, 16-byte aligned and of dz's dtype")
    build.require(x.shape[0] == dz.shape[0], f"flce_dw: dz has {dz.shape[0]} rows, x {x.shape[0]}")
    build.require(x.shape[1] % (16 // x.element_size()) == 0, f"flce_dw: H {x.shape[1]} breaks 16-byte rows")
    build.require_device(dz.device, x)
    out = torch.empty(dz.shape[1], x.shape[1], dtype=x.dtype, device=x.device)
    _dw_kernel(dz, x, out, None, 0)
    return out


def run_rows(N: int, V: int, itemsize: int, dz_budget: int) -> int:
    """Rows of one dz run: all N when N x V elements fit ``dz_budget`` bytes,
    else the most that do, at least one."""
    pitch = -(-V // _LD_ALIGN) * _LD_ALIGN * itemsize
    return max(1, min(N, dz_budget // pitch))


def flce_backward(x, w, target, lse, a, c, softcap=None, label_smoothing=0.0, dz_budget: int = DZ_BUDGET_BYTES,
                  need_dx: bool = True, need_dw: bool = True, vocab_size: Optional[int] = None
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(dx, dw)`` of the loss from the saved ``lse`` and the per-row ``a``,
    ``c``: dz for runs of rows within ``dz_budget`` bytes, each run's dx,
    and dw added over the runs (in an fp32 buffer when there are several);
    the smoothing spread over ``vocab_size`` (V by default). A CPU tensor
    takes the plain version; a CUDA tensor the kernels."""
    build.require_no_grad("flce_backward", x, w)
    _check_inputs("flce_backward", x, w, target)
    cap = _check_softcap(softcap)
    if x.device.type == "cpu":
        return flce_backward_plain(x, w, target, lse, a, c, softcap, label_smoothing, need_dx=need_dx,
                                   need_dw=need_dw, vocab_size=vocab_size)
    _check_kernel_inputs("flce_backward", x, w, target)
    _f32(lse, a, c)
    N, V = x.shape[0], w.shape[0]
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(w) if need_dw else None
    if N == 0:
        return dx, (dw.zero_() if need_dw else None)
    rows = run_rows(N, V, x.element_size(), dz_budget)
    starts = list(range(0, N, rows))
    buf = torch.empty(V, x.shape[1], dtype=torch.float32, device=x.device) if need_dw and len(starts) > 1 else None
    dz = _dz_buffer(rows, V, x)
    for i, r0 in enumerate(starts):
        n = min(rows, N - r0)
        run = _dz_kernel(x, w, target, lse, a, c, cap, label_smoothing, r0, n, dz[:n], vocab_size)
        if need_dx:
            _dx_kernel(run, w, dx[r0:r0 + n])
        if need_dw:
            mode = 0 if buf is None else (1 if i == 0 else 3 if i == len(starts) - 1 else 2)
            _dw_kernel(run, x[r0:r0 + n], dw, buf, mode)
    return dx, dw
