"""Kernel D's tensor-core arithmetic on the CPU.

``csrc/paged_prefill.cu`` runs bf16 / fp16 prefill on the mma.sync tiles of
``csrc/flash_tiles.cuh``: a block packs 64 (token, head) rows, 64 / group
tokens of one kv head's query heads; it walks 64-key tiles (32 at D 256),
finding each key row through the block table (page ``table[pos // bs]``,
row ``pos % bs``; a position past the tile's last visible key or on an
entry < 0 is masked, never read); S takes Q and K exactly (fp32 sums), is
scaled to log2 units in fp32 and masked by the chunked causal predicate
(key position <= kv_len - q_len + token); the online softmax's P enters the
PV product as hi + lo of the working type. Over int8 pages (D') K and V
are converted to the working type (exact), the key scale is folded into Q
in fp32 and Q * key_scale is rounded to the working type once, and the
value scale multiplies the normalized output.

``tiled_model`` repeats that arithmetic in plain PyTorch and is held to the
kernel's plain version (the golden, which ``tests/test_torch_ops.py`` holds
to JAX) under chip_smoke.py's ``PAGED_PREFILL_REL_LIMITS``, at block sizes
16, 32 and 64, chunked prefill, both layouts and GQA orders, D 64, 128 and
256, Seed-OSS-36B's group 10 and group 64. Against a float64 reference of
the same function, the split P keeps the model's fp32 output within 2e-5
relative, where rounding P once moves it 50x more (0.86-1.0e-3 in bf16,
1.0-1.3e-4 in fp16). Over int8 pages the rounding of Q * key_scale moves
it by about as much (it read 1.0-1.2e-3 in bf16), which keeps the kernel
no farther from the float64 function than the plain version, whose
probabilities are rounded to the working type (hi + lo of Q * key_scale
would double the QK product). A call on tensors off the CPU reaches the
launch (no fallback to the plain version).
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels import paged_prefill

BF16, F16 = torch.bfloat16, torch.float16
# (q_lens, kv_lens, hq, hkv, D, block size, gqa, layout, int8 pages)
CASES = {
    "bs16-chunked": ([37, 70], [37, 150], 8, 2, 64, 16, "AABB", "NHD", False),
    "bs32-abab-hnd": ([90, 1, 33], [90, 70, 33], 8, 2, 64, 32, "ABAB", "HND", False),
    "d128-empty-seq": ([40, 0, 3], [100, 0, 3], 4, 1, 128, 64, "AABB", "NHD", False),
    "d256": ([45, 4], [45, 80], 4, 2, 256, 64, "AABB", "HND", False),
    "group10": ([20, 3], [50, 3], 20, 2, 64, 16, "ABAB", "NHD", False),
    "group64": ([5, 2], [30, 2], 64, 1, 64, 32, "AABB", "HND", False),
    "int8-bs16": ([37, 70], [37, 150], 8, 2, 64, 16, "AABB", "HND", True),
    "int8-d256": ([45, 4], [45, 80], 4, 2, 256, 64, "ABAB", "HND", True),
    "int8-group10": ([20, 3], [50, 3], 20, 2, 64, 32, "AABB", "HND", True),
}
SPLIT_P_CASES = ("bs16-chunked", "d256", "group10")
INT8_CASES = ("int8-bs16", "int8-d256", "int8-group10")


def randn(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def prefill_inputs(name, dtype):
    """Random pages, a shuffled block table with -1 past each sequence's pages, and queries (numpy seed)."""
    q_lens, kv_lens, hq, hkv, d, bs, gqa, layout, int8 = CASES[name]
    rng = np.random.default_rng(sum(kv_lens) + hq + d + bs)
    need = [-(-n // bs) for n in kv_lens]
    n_blocks, cols = sum(need) + 3, max(need) + 1
    perm = rng.permutation(n_blocks)
    table, used = np.full((len(kv_lens), cols), -1, np.int32), 0
    for b, n in enumerate(need):
        table[b, :n] = perm[used:used + n]
        used += n
    shape = (n_blocks, hkv, bs, d) if layout == "HND" else (n_blocks, bs, hkv, d)
    if int8:
        kc, vc = (torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)) for _ in range(2))
        ks, vs = (torch.from_numpy((rng.random((hkv, d)) * 0.015 + 0.005).astype(np.float32)) for _ in range(2))
    else:
        kc, vc = randn(rng, shape).to(dtype), randn(rng, shape).to(dtype)
        ks = vs = None
    q = randn(rng, (sum(q_lens), hq, d)).to(dtype)
    cu = lambda lens: torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))  # noqa: E731
    return q, kc, vc, cu(q_lens), cu(kv_lens), torch.from_numpy(table), gqa, layout, ks, vs


def on_split_grid(x, dtype):
    """fp32 x rounded, half away from zero, to the 2p significant bits hi + lo of dtype carry
    (csrc/flash_tiles.cuh round_split)."""
    drop = 8 if dtype == BF16 else 2
    u = x.contiguous().view(torch.int32)
    return ((u + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


def operand(x, dtype, split):
    """fp32 x as the kernel's MMA operand: [hi, lo] of dtype on the split grid, or [x rounded once]."""
    if not split:
        return [x.to(dtype).float()]
    g = on_split_grid(x, dtype)
    hi = g.to(dtype).float()
    return [hi, (g - hi).to(dtype).float()]


def tiled_model(q, kc, vc, cu_q, cu_kv, table, gqa, layout, ks=None, vs=None, split=True):
    """The kernel's arithmetic, block by block and key tile by key tile; returns its fp32 output (before the
    rounding to q's dtype)."""
    T, hq, D = q.shape
    dtype = q.dtype
    hkv, bs = (kc.shape[1], kc.shape[2]) if layout == "HND" else (kc.shape[2], kc.shape[1])
    group, BK = hq // hkv, (32 if D >= 256 else 64)
    tpt = 64 // group
    sl2 = D ** -0.5 * math.log2(math.e)
    out = torch.zeros(T, hq, D)
    for b in range(table.shape[0]):
        q0, q_len = int(cu_q[b]), int(cu_q[b + 1] - cu_q[b])
        kv_len = int(cu_kv[b + 1] - cu_kv[b])
        for kvh in range(hkv):
            heads = torch.tensor([g * hkv + kvh if gqa == "ABAB" else kvh * group + g for g in range(group)])
            for tok0 in range(0, q_len, tpt):
                n_tok = min(tpt, q_len - tok0)
                toks = torch.arange(q0 + tok0, q0 + tok0 + n_tok).repeat_interleave(group)
                hs = heads.repeat(n_tok)  # row r = (token r // group, head r % group)
                rows = q[toks, hs].float()
                abs0 = kv_len - q_len + tok0
                row_abs = abs0 + torch.arange(n_tok * group) // group
                kv_end = max(0, min(kv_len, abs0 + n_tok))
                qa = rows * ks[kvh] if ks is not None else rows  # Q * key_scale rounded to dtype once
                qa = qa.to(dtype).float()
                m = torch.full((len(rows),), -math.inf)
                l, acc = torch.zeros(len(rows)), torch.zeros(len(rows), D)
                for j0 in range(0, kv_end, BK):
                    pos = torch.arange(j0, j0 + BK)
                    lb = pos // bs
                    page = torch.where((pos < kv_end) & (lb < table.shape[1]),
                                       table[b, lb.clamp(max=table.shape[1] - 1)], -1)
                    ok = page >= 0
                    row = pos % bs
                    at = (page.clamp(min=0), kvh, row) if layout == "HND" else (page.clamp(min=0), row, kvh)
                    kt, vt = (torch.where(ok[:, None], c[at].to(dtype).float(), 0.0) for c in (kc, vc))
                    s = (qa @ kt.T) * sl2
                    s = s.masked_fill(~(ok[None] & (pos[None] <= row_abs[:, None])), -math.inf)
                    m_new = torch.maximum(m, s.amax(1))
                    base = torch.where(torch.isneginf(m_new), 0.0, m_new)
                    p = torch.exp2(s - base[:, None])
                    alpha = torch.exp2(m - base)
                    l, m = l * alpha + p.sum(1), m_new
                    acc = acc * alpha[:, None] + sum(part @ vt for part in operand(p, dtype, split))
                o = torch.where(l[:, None] > 0, acc / l.clamp(min=1e-38)[:, None], 0.0)
                out[toks, hs] = o * vs[kvh] if vs is not None else o
    return out


def reference64(q, kc, vc, cu_q, cu_kv, table, gqa, layout, ks=None, vs=None):
    """The same function in float64 with nothing rounded: the dequantized pages, probabilities in full."""
    T, hq, D = q.shape
    hkv, bs = (kc.shape[1], kc.shape[2]) if layout == "HND" else (kc.shape[2], kc.shape[1])
    group = hq // hkv
    out = torch.zeros(T, hq, D, dtype=torch.float64)
    for b in range(table.shape[0]):
        q0, q_len = int(cu_q[b]), int(cu_q[b + 1] - cu_q[b])
        kv_len = int(cu_kv[b + 1] - cu_kv[b])
        if q_len == 0:
            continue
        pos = torch.arange(kv_len)
        at = (table[b, pos // bs].long(), slice(None), pos % bs) if layout == "HND" else (
            table[b, pos // bs].long(), pos % bs)
        k, v = (c[at].double() for c in (kc, vc))  # (kv_len, hkv, D)
        if ks is not None:
            k, v = k * ks.double(), v * vs.double()
        idx = torch.arange(hq)
        kvh = idx % hkv if gqa == "ABAB" else idx // group
        s = torch.einsum("qhd,khd->hqk", q[q0:q0 + q_len].double(), k[:, kvh]) * D ** -0.5
        keep = pos[None] <= (kv_len - q_len + torch.arange(q_len))[:, None]
        p = torch.softmax(s.masked_fill(~keep, -math.inf), -1)
        out[q0:q0 + q_len] = torch.einsum("hqk,khd->qhd", p, v[:, kvh])
    return out


def _plain(q, kc, vc, cu_q, cu_kv, table, gqa, layout, ks, vs):
    return paged_prefill.paged_prefill_gqa_plain(q, kc, vc, cu_q, table, None, cu_kv, gqa, layout,
                                                 key_scale=ks, value_scale=vs)


@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("name", list(CASES))
def test_tiled_model_holds_the_plain_version_within_limits(name, dtype):
    inputs = prefill_inputs(name, dtype)
    got = tiled_model(*inputs).to(dtype)
    whole, row, _ = chip_smoke.rel_errors(got, _plain(*inputs))
    limit = chip_smoke.PAGED_PREFILL_REL_LIMITS["bf16" if dtype == BF16 else "fp16"]
    assert whole <= limit[0] and row <= limit[1], f"{whole:.3g} / {row:.3g} over {limit}"


@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("name", SPLIT_P_CASES)
def test_split_p_keeps_fp32_accuracy(name, dtype):
    """Against the float64 function, the split P keeps the fp32 output within 2e-5 relative (it read at most
    4.1e-6); P rounded once moves it 50x more (it read 0.86-1.0e-3 in bf16, 1.0-1.3e-4 in fp16)."""
    inputs = prefill_inputs(name, dtype)
    want = reference64(*inputs).float()
    split = chip_smoke.rel_errors(tiled_model(*inputs), want)[0]
    rounded = chip_smoke.rel_errors(tiled_model(*inputs, split=False), want)[0]
    assert split <= 2e-5, split
    assert rounded >= (5e-4 if dtype == BF16 else 5e-5) and rounded >= 50 * split, (split, rounded)


@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("name", INT8_CASES)
def test_int8_pages_stay_as_close_to_the_function_as_the_plain_version(name, dtype):
    """Over int8 pages Q * key_scale is rounded once; against the float64 function the kernel's arithmetic is
    no farther off than the plain version, which rounds its probabilities to the working type (it read 1.0-1.2e-3
    against the plain version's 2.1-2.3e-3 in bf16)."""
    inputs = prefill_inputs(name, dtype)
    want = reference64(*inputs).float()
    kernel = chip_smoke.rel_errors(tiled_model(*inputs), want)[0]
    plain = chip_smoke.rel_errors(_plain(*inputs).float(), want)[0]
    assert kernel <= plain, (kernel, plain)


def test_int8_page_values_convert_exactly():
    """|v| <= 128 is exact in bf16 and fp16: the converted K/V tiles hold the pages' values."""
    v = torch.arange(-128, 128, dtype=torch.int8)
    for dtype in (BF16, F16):
        assert torch.equal(v.to(dtype).float(), v.float())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-pages", "int8-pages"])
def test_prefill_never_falls_back(monkeypatch, int8):
    """A tensor off the CPU goes to the kernel: with meta lengths and tables (no values to read) the wrapper
    reaches the launch, which raises here without a build, and counts no launch."""
    monkeypatch.setattr(build, "load_library", lambda: (_ for _ in ()).throw(RuntimeError("no kernels built")))
    meta = lambda *shape, dtype=BF16: torch.empty(shape, device="meta", dtype=dtype)  # noqa: E731
    cache = (lambda: meta(9, 2, 16, 128, dtype=torch.int8)) if int8 else (lambda: meta(9, 2, 16, 128))
    scales = dict(key_scale=meta(2, 128, dtype=torch.float32), value_scale=meta(2, 128, dtype=torch.float32)) \
        if int8 else {}
    before = paged_prefill.launches
    with pytest.raises(RuntimeError, match="no kernels built"):
        paged_prefill.paged_prefill_gqa(meta(40, 20, 128), cache(), cache(), meta(3, dtype=torch.int32),
                                        meta(2, 5, dtype=torch.int32), None, meta(3, dtype=torch.int32),
                                        "AABB", "HND", max_q_len=30, **scales)
    assert paged_prefill.launches == before
