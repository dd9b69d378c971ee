"""Kernel I: absorbed MLA attention over the paged latent cache
(``csrc/mla_decode.cu``) and its plain PyTorch version.

Replaces the JAX package's ``backends/pallas/kernels/mla_decode.py:151``
(``mla_decode_absorbed``). The plain version is the JAX package's XLA tier
(``backends/xla/operators/mla.py:51-167``): an online-softmax scan over
the logical blocks in the latent space, written per query row so that one
function serves decode (a row per sequence) and prefill (a row per packed
query token with its causal limit). ``launches`` counts the wrapper's
launches (a split call's merge launch included in the one).

bf16 and fp16 run tensor-core tiles of 64 heads of one row over a column
block of the latent (``column_tile``), the row's positions in 32-position
stages (two where they fit in shared memory, else one: the kernel sizes
its ring), the KV walk split ``split_count`` ways, a number read from
shapes alone, with a merge launch in split order when it is above 1. fp32
runs the scalar kernel (``FP32_MAX_LATENT``, ``FP32_MAX_WIDTH``).
``takes`` says which shapes the kernel takes; the ops send the others to
the golden.
"""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.backends.cuda import build

launches = 0

FP32_MAX_LATENT = 512  # fp32 r: two latent columns per thread of the scalar kernel's 256
FP32_MAX_WIDTH = 576  # fp32 r + dr: one row of the scalar kernel's shared-memory tiles
ROWS = 64  # query rows of a tensor-core tile: 64 heads of one row
KEYS = 32  # positions of a ring stage
COLUMN_TILES = (512, 256, 128)  # latent columns of a block: 8 warps x 64, 32 or 16
# the widest staged row (r + dr rounded up to 16, at least the column blocks' span) that one ring stage fits beside
# the query tile in shared memory (csrc kMaxRowI)
MAX_ROW = 1088
# a split walks at least two stages of the table's width: the split sweep (benchmark/split_sweep.py mla) had 16
# splits fastest at the smoke's bs-4 decode (0.0248 ms against 0.0319 at 9, a 4-stage floor's count) and 32-66 at
# bs 1 over ctx 4096-32768, within 6% of the best there
MIN_SPLIT_KEYS = 2 * KEYS
MAX_SPLITS = 256  # the merge takes at most this many
_NEG = -1e30  # the XLA tier's mask value


def column_tile(r: int) -> int:
    """Latent columns of a block: the widest of ``COLUMN_TILES`` that
    divides r, else 128 (the last block's columns past r are not stored)."""
    return next((c for c in COLUMN_TILES if r % c == 0), COLUMN_TILES[-1])


def takes(dtype: torch.dtype, r: int, dr: int) -> bool:
    """Whether the kernel takes latent width r and rope width dr in dtype:
    whole 16-byte rows, and for 16-bit types a staged row of at most
    ``MAX_ROW`` elements, for fp32 the scalar kernel's widths."""
    if r <= 0 or dr <= 0:
        return False
    if dtype == torch.float32:
        return r % 4 == 0 and dr % 4 == 0 and r <= FP32_MAX_LATENT and r + dr <= FP32_MAX_WIDTH
    tile = column_tile(r)
    row = max(-(-(r + dr) // 16) * 16, -(-r // tile) * tile)
    return dtype in (torch.bfloat16, torch.float16) and r % 8 == 0 and dr % 8 == 0 and row <= MAX_ROW


def split_count(rows: int, heads: int, r: int, table_keys: int, sms: int = build.H100_SMS) -> int:
    """Splits of each row's KV walk, from shapes alone (never a length: that
    would sync the host with the card, and a CUDA graph's replay would keep
    a stale one): as many as keep the (row, head tile, column block) units
    within one wave of the SMs (one block an SM), each split walking at least
    ``MIN_SPLIT_KEYS`` of the table's width; 1 once the units fill a wave."""
    units = rows * -(-heads // ROWS) * -(-r // column_tile(r))
    if units >= sms:
        return 1
    return max(1, min(sms // units, -(-table_keys // MIN_SPLIT_KEYS), MAX_SPLITS))


def mla_decode_absorbed_plain(
    q_lat: torch.Tensor,
    q_pe: torch.Tensor,
    c_cache: torch.Tensor,
    pe_cache: torch.Tensor,
    row_lens: torch.Tensor,
    block_tables: torch.Tensor,
    row_seqs: Optional[torch.Tensor] = None,
    sink: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The scan of the XLA tier (:73-96 there), in fp32: row i attends over
    the first ``row_lens[i]`` positions of sequence ``row_seqs[i]`` (of
    sequence i without ``row_seqs``), skipping table entries < 0. Returns
    the normalized latent (R, H, r) fp32, 0 where nothing was attended."""
    R, H, r = q_lat.shape
    dr = q_pe.shape[-1]
    bs, NB = c_cache.shape[2], block_tables.shape[1]
    rows = torch.arange(R, device=q_lat.device) if row_seqs is None else row_seqs.long()
    ql, qp = q_lat.float(), q_pe.float()
    m = torch.full((R, H), _NEG, device=q_lat.device)
    l = torch.zeros((R, H), device=q_lat.device)
    acc = torch.zeros((R, H, r), device=q_lat.device)
    for lb in range(NB):
        phys = block_tables[rows, lb]
        safe = phys.clamp(0, c_cache.shape[0] - 1).long()
        c = c_cache[safe, 0].float()  # (R, bs, r)
        pe = pe_cache[safe, 0, :, :dr].float()
        s = torch.einsum("rhk,rsk->rhs", ql, c) + torch.einsum("rhd,rsd->rhs", qp, pe)
        kv_pos = lb * bs + torch.arange(bs, device=q_lat.device)
        keep = ((kv_pos[None, :] < row_lens[:, None]) & (phys >= 0)[:, None])[:, None, :]
        s = torch.where(keep, s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(keep, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("rhs,rsk->rhk", p, c)
        m = m_new
    if sink is not None:  # _finish (:42-48 there)
        l = l + torch.exp(sink.float()[None, :] - m)
    return acc / l.clamp(min=1e-38)[..., None]


def mla_decode_absorbed(
    q_lat: torch.Tensor,
    q_pe: torch.Tensor,
    c_cache: torch.Tensor,
    pe_cache: torch.Tensor,
    row_lens: torch.Tensor,
    block_tables: torch.Tensor,
    row_seqs: Optional[torch.Tensor] = None,
    sink: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Latent attention of ``q_lat`` (R, H, r) and ``q_pe`` (R, H, dr),
    softmax scale folded in, over the caches ``c_cache`` (N, 1, bs, r) and
    ``pe_cache`` (N, 1, bs, dr), with int32 ``row_lens`` (R,),
    ``block_tables`` (B, NB) and ``row_seqs`` (R,) (None: row i is sequence
    i), and an optional fp32 per-head ``sink`` (H,). Returns (R, H, r) fp32.

    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    args = (q_lat, q_pe, c_cache, pe_cache, row_lens, block_tables, row_seqs, sink)
    build.require_no_grad("mla_decode_absorbed", *args)
    if q_lat.device.type == "cpu":
        return mla_decode_absorbed_plain(*args)
    return _mla_kernel(*args)


def _mla_kernel(q_lat, q_pe, c_cache, pe_cache, row_lens, block_tables, row_seqs, sink):
    global launches
    code = build.dtype_code(q_lat)
    build.require(q_lat.ndim == 3 and q_pe.ndim == 3 and c_cache.ndim == 4 and pe_cache.ndim == 4,
                  "mla_decode: q_lat/q_pe must be (R, H, dim) and the caches (N, 1, block_size, dim)")
    R, H, r = q_lat.shape
    dr = q_pe.shape[-1]
    N, _, bs, _ = c_cache.shape
    build.require(
        q_pe.shape[:2] == (R, H) and tuple(c_cache.shape) == (N, 1, bs, r) and tuple(pe_cache.shape) == (N, 1, bs, dr),
        f"mla_decode: shapes do not match: q_lat {tuple(q_lat.shape)}, q_pe {tuple(q_pe.shape)}, caches "
        f"{tuple(c_cache.shape)} and {tuple(pe_cache.shape)}",
    )
    build.require(all(t.dtype == q_lat.dtype for t in (q_pe, c_cache, pe_cache)),
                  f"mla_decode: queries and caches share one dtype, got {q_lat.dtype}, {q_pe.dtype}, "
                  f"{c_cache.dtype}, {pe_cache.dtype}")
    build.require(takes(q_lat.dtype, r, dr),
                  f"mla_decode: the kernel takes r and dr of whole 16-byte rows, in fp32 r <= {FP32_MAX_LATENT} and "
                  f"r + dr <= {FP32_MAX_WIDTH}, in bf16/fp16 a staged row of at most {MAX_ROW} elements (the query tile "
                  f"and one stage in shared memory); "
                  f"got r = {r}, dr = {dr} in {q_lat.dtype}")
    build.require_device(q_lat.device, q_pe, c_cache, pe_cache, row_lens, block_tables)
    for name, t in (("q_lat", q_lat), ("q_pe", q_pe), ("c_cache", c_cache), ("pe_cache", pe_cache)):
        build.require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                      f"mla_decode: {name} must be contiguous and 16-byte aligned")
    int32 = lambda t, shape: t.dtype == torch.int32 and t.is_contiguous() and tuple(t.shape) == shape  # noqa: E731
    build.require(block_tables.ndim == 2 and int32(block_tables, tuple(block_tables.shape)),
                  f"mla_decode: block_tables must be contiguous int32 (B, NB), got {block_tables.dtype} "
                  f"{tuple(block_tables.shape)}")
    build.require(int32(row_lens, (R,)), f"mla_decode: row_lens must be contiguous int32 ({R},), got "
                                         f"{row_lens.dtype} {tuple(row_lens.shape)}")
    if row_seqs is None:
        build.require(block_tables.shape[0] == R, f"mla_decode: without row_seqs there is one table row per "
                                                  f"query row ({R}), got {block_tables.shape[0]}")
    else:
        build.require_device(q_lat.device, row_seqs)
        build.require(int32(row_seqs, (R,)), f"mla_decode: row_seqs must be contiguous int32 ({R},)")
    if sink is not None:
        build.require_device(q_lat.device, sink)
        build.require(sink.dtype == torch.float32 and tuple(sink.shape) == (H,) and sink.is_contiguous(),
                      f"mla_decode: sink must be contiguous float32 ({H},)")
    out = torch.empty((R, H, r), dtype=torch.float32, device=q_lat.device)
    if R == 0:
        return out
    fp32 = q_lat.dtype == torch.float32
    splits = 1 if fp32 else split_count(R, H, r, block_tables.shape[1] * bs, build.sm_count(q_lat.device))
    # per split, head and row: the unnormalized acc (r), then every (max, sum); held until the launch is queued
    partial = torch.empty(R * H * splits * (r + 2), dtype=torch.float32, device=q_lat.device) if splits > 1 else None
    build.launch(
        "mojo_mla_decode", q_lat.device,
        q_lat.data_ptr(), q_pe.data_ptr(), c_cache.data_ptr(), pe_cache.data_ptr(), row_lens.data_ptr(),
        None if row_seqs is None else row_seqs.data_ptr(), block_tables.data_ptr(),
        None if sink is None else sink.data_ptr(), out.data_ptr(), None if partial is None else partial.data_ptr(),
        R, H, r, dr, bs, block_tables.shape[1], column_tile(r), splits, code,
    )
    launches += 1
    return out
