"""cuda-tier attention: paged decode and prefill (kernels C and D,
``csrc/paged_decode.cu`` and ``csrc/paged_prefill.cu``), the same kernels
over int8 (C8) pages (C' and D'), the windowed paged decode on C and C'
(``CudaPagedDecodeSWA``, ``CudaPagedDecodeSWAWithKVDequant``: the kernel
skips the pages outside the window, as the JAX tier's does,
``backends/pallas/operators/attention.py:321-386``), and the dense ops of
the training path on kernel J (``csrc/flash_swa.cu``): ``CudaSWA``,
``CudaSdpa`` and ``CudaPrefillGQA`` run J's forward under its autograd
Function, so they carry gradients; ``CudaSdpa`` with a bool mask runs
kernel O (``csrc/flash_diffusion.cu``) under its own. The KV-dequant ops
take no ``compute_dtype=torch.int8`` and no ``query_scale`` here: those
raise, they do not fall back to the golden. Routes that take the golden,
each counted in its class's ``golden_calls``: a non-causal windowed decode
(:339-343), ``CudaSdpa``'s additive float mask (:134-149), a custom mask on
a non-causal paged decode (:65-72) and any custom mask on a paged prefill
(:98-106), as in JAX (the int8-page ops alike); and in every op here, a
head_dim the kernels do not take (``takes_head_dim``: a multiple of 16 up
to 256; 16, 80 and 96 run on the kernels, padded to the next instantiated
width), as JAX's Pallas ops send ``D % 128 != 0`` to their golden (:66,
:101, :138, :200). A group of any size runs on the kernels."""

from __future__ import annotations

import math
from typing import Optional

import torch

from mojo_opset_tpu_torch.backends.cuda.functions.attention import flash_attention
from mojo_opset_tpu_torch.backends.cuda.functions.diffusion_attention import diffusion_attention
from mojo_opset_tpu_torch.backends.cuda.kernels.flash_swa import flash_swa_bwd, flash_swa_fwd
from mojo_opset_tpu_torch.backends.cuda.kernels.paged_decode import paged_decode_gqa, takes_head_dim
from mojo_opset_tpu_torch.backends.cuda.kernels.paged_prefill import paged_prefill_gqa
from mojo_opset_tpu_torch.core.operators.attention import (
    MojoPagedDecodeGQA,
    MojoPagedDecodeSWA,
    MojoPagedPrefillGQA,
    MojoPrefillGQA,
    MojoSdpa,
    MojoSWA,
    _require_int32,
)
from mojo_opset_tpu_torch.experimental.operators.kv_quant_attention import (
    MojoPagedDecodeGQAWithKVDequant,
    MojoPagedDecodeSWAWithKVDequant,
    MojoPagedPrefillGQAWithKVDequant,
)


def _golden_head_dim(cls, head_dim: int) -> bool:
    """Whether a call with ``head_dim`` takes the golden (the kernels do
    not take it); counted in ``cls.golden_calls``."""
    if takes_head_dim(head_dim):
        return False
    cls.golden_calls += 1
    return True


def _check_kernel_options(op, query_scale) -> None:
    if op.compute_dtype == torch.int8:
        raise NotImplementedError("compute_dtype=torch.int8 runs in the golden tier only (MOJO_BACKEND=ref)")
    op._check_query_scale(query_scale)


def _golden_mask(cls, takes_golden: bool) -> bool:
    """Whether a call with a custom mask takes the golden (``takes_golden``);
    counted in ``cls.golden_calls``."""
    cls.golden_calls += takes_golden
    return takes_golden


class CudaPagedDecodeGQA(MojoPagedDecodeGQA):
    golden_calls = 0

    def forward(
        self,
        query: torch.Tensor,
        key_cache: torch.Tensor,
        value_cache: torch.Tensor,
        total_seq_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        mask: Optional[torch.Tensor] = None,
        *,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        if (_golden_mask(CudaPagedDecodeGQA, mask is not None and not self.is_causal)
                or _golden_head_dim(CudaPagedDecodeGQA, query.shape[-1])):
            return super().forward(query, key_cache, value_cache, total_seq_lens, block_tables, softmax_scale, mask)
        return paged_decode_gqa(
            query, key_cache, value_cache, total_seq_lens, block_tables,
            softmax_scale, self.gqa_layout, self.kv_layout,
        )


def _max_q_len(query: torch.Tensor, max_q_len: Optional[int]) -> int:
    """``max_q_len`` as given, else the packed token count ``query.shape[0]``:
    an upper bound on every segment's length, read from shapes as the JAX op
    does, with no host read of ``cu_q_lens`` (so the call stays capturable).
    Kernel D's grid needs a host int; its query tiles past a segment's
    length exit at once."""
    return query.shape[0] if max_q_len is None else max_q_len


class CudaPagedPrefillGQA(MojoPagedPrefillGQA):
    golden_calls = 0

    def forward(
        self,
        query: torch.Tensor,
        key_cache: torch.Tensor,
        value_cache: torch.Tensor,
        cu_q_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        cu_total_seq_lens: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        max_q_len: Optional[int] = None,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        if _golden_mask(CudaPagedPrefillGQA, mask is not None) or _golden_head_dim(CudaPagedPrefillGQA,
                                                                                  query.shape[-1]):
            return super().forward(query, key_cache, value_cache, cu_q_lens, block_tables, softmax_scale,
                                   cu_total_seq_lens, mask, max_q_len, max_total_seq_len)
        return paged_prefill_gqa(
            query, key_cache, value_cache, cu_q_lens, block_tables, softmax_scale, cu_total_seq_lens,
            self.gqa_layout, self.kv_layout, is_causal=self.is_causal, max_q_len=_max_q_len(query, max_q_len),
        )


class CudaPagedDecodeGQAWithKVDequant(MojoPagedDecodeGQAWithKVDequant):
    golden_calls = 0

    def forward(
        self,
        query: torch.Tensor,
        query_scale: Optional[torch.Tensor],
        key_cache: torch.Tensor,
        key_scale: torch.Tensor,
        value_cache: torch.Tensor,
        value_scale: torch.Tensor,
        total_seq_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        mask: Optional[torch.Tensor] = None,
        *,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        _check_kernel_options(self, query_scale)
        if (_golden_mask(CudaPagedDecodeGQAWithKVDequant, mask is not None and not self.is_causal)
                or _golden_head_dim(CudaPagedDecodeGQAWithKVDequant, query.shape[-1])):
            return super().forward(query, query_scale, key_cache, key_scale, value_cache, value_scale,
                                   total_seq_lens, block_tables, softmax_scale, mask)
        return paged_decode_gqa(
            query, key_cache, value_cache, total_seq_lens, block_tables, softmax_scale, self.gqa_layout, "HND",
            key_scale, value_scale,
        )


class CudaPagedDecodeSWA(MojoPagedDecodeSWA):
    """Kernel C with the op's windows. A non-causal call sees every key; it
    takes the golden, as the JAX tier does (:339-343), and ``golden_calls``
    counts it, as it counts a head_dim the kernel does not take."""

    golden_calls = 0

    def forward(
        self,
        query: torch.Tensor,
        key_cache: torch.Tensor,
        value_cache: torch.Tensor,
        total_seq_lens: torch.Tensor,
        block_table: torch.Tensor,
        softmax_scale: Optional[float] = None,
        *,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        if not self.is_causal or _golden_head_dim(CudaPagedDecodeSWA, query.shape[-1]):
            CudaPagedDecodeSWA.golden_calls += not self.is_causal
            return super().forward(query, key_cache, value_cache, total_seq_lens, block_table, softmax_scale)
        return paged_decode_gqa(
            query, key_cache, value_cache, total_seq_lens, block_table, softmax_scale, self.gqa_layout,
            self.kv_layout, local_window=self.local_window_size, global_window=self.global_window_size,
        )


class CudaPagedDecodeSWAWithKVDequant(MojoPagedDecodeSWAWithKVDequant):
    """Kernel C' with the op's windows; a non-causal call takes the golden,
    counted in ``golden_calls``, as ``CudaPagedDecodeSWA``'s."""

    golden_calls = 0

    def forward(
        self,
        query: torch.Tensor,
        query_scale: Optional[torch.Tensor],
        key_cache: torch.Tensor,
        key_scale: torch.Tensor,
        value_cache: torch.Tensor,
        value_scale: torch.Tensor,
        total_seq_lens: torch.Tensor,
        block_table: torch.Tensor,
        softmax_scale: Optional[float] = None,
        *,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        _check_kernel_options(self, query_scale)
        if not self.is_causal or _golden_head_dim(CudaPagedDecodeSWAWithKVDequant, query.shape[-1]):
            CudaPagedDecodeSWAWithKVDequant.golden_calls += not self.is_causal
            return super().forward(query, query_scale, key_cache, key_scale, value_cache, value_scale,
                                   total_seq_lens, block_table, softmax_scale)
        return paged_decode_gqa(
            query, key_cache, value_cache, total_seq_lens, block_table, softmax_scale, self.gqa_layout, "HND",
            key_scale, value_scale, self.local_window_size, self.global_window_size,
        )


class CudaPagedPrefillGQAWithKVDequant(MojoPagedPrefillGQAWithKVDequant):
    golden_calls = 0

    def forward(
        self,
        query: torch.Tensor,
        query_scale: Optional[torch.Tensor],
        key_cache: torch.Tensor,
        key_scale: torch.Tensor,
        value_cache: torch.Tensor,
        value_scale: torch.Tensor,
        cu_q_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        cu_total_seq_lens: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        max_q_len: Optional[int] = None,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        _check_kernel_options(self, query_scale)
        if (_golden_mask(CudaPagedPrefillGQAWithKVDequant, mask is not None)
                or _golden_head_dim(CudaPagedPrefillGQAWithKVDequant, query.shape[-1])):
            return super().forward(query, query_scale, key_cache, key_scale, value_cache, value_scale, cu_q_lens,
                                   block_tables, softmax_scale, cu_total_seq_lens, mask, max_q_len, max_total_seq_len)
        return paged_prefill_gqa(
            query, key_cache, value_cache, cu_q_lens, block_tables, softmax_scale, cu_total_seq_lens,
            self.gqa_layout, "HND", is_causal=self.is_causal, max_q_len=_max_q_len(query, max_q_len),
            key_scale=key_scale, value_scale=value_scale,
        )


def _cu_uniform(batch: int, length: int, device) -> torch.Tensor:
    """cu vector of ``batch`` sequences of ``length`` rows each."""
    return torch.arange(batch + 1, dtype=torch.int32, device=device) * length


class CudaSWA(MojoSWA):
    """``fwd`` and ``bwd`` are J's wrappers; a plain twin on the card sets
    them to ``flash_swa_fwd_plain`` and ``flash_swa_bwd_plain``."""

    fwd = staticmethod(flash_swa_fwd)
    bwd = staticmethod(flash_swa_bwd)
    golden_calls = 0

    def forward(self, query, key, value, cu_q_lens, cu_total_seq_lens, softmax_scale=None):
        if _golden_head_dim(CudaSWA, query.shape[-1]):
            return super().forward(query, key, value, cu_q_lens, cu_total_seq_lens, softmax_scale)
        return flash_attention(query, key, value, cu_q_lens, cu_total_seq_lens, self.is_causal,
                               self.local_window_size, self.global_window_size, softmax_scale, self.gqa_layout,
                               self.fwd, self.bwd)


class CudaSdpa(MojoSdpa):
    """A maskless call runs on J as B equal-length non-causal sequences, the
    leading dims flattened into B (the JAX tier's varlen route,
    ``backends/pallas/operators/attention.py:169-187``). A bool mask that
    broadcasts to (..., Hq, Lq, Lk) runs on kernel O, the leading dims
    flattened into B and the mask passed as a broadcast view (never
    materialized); a row whose mask keeps no key gives NaN, as the golden's
    softmax does. An additive float mask takes the golden, as the JAX tier's
    does (:134-149), counted in ``golden_calls``."""

    golden_calls = 0

    def forward(self, query, key, value, attn_mask=None):
        if (attn_mask is not None and attn_mask.dtype != torch.bool) or _golden_head_dim(CudaSdpa, query.shape[-1]):
            CudaSdpa.golden_calls += attn_mask is not None and attn_mask.dtype != torch.bool
            return super().forward(query, key, value, attn_mask)
        *lead, Hq, Lq, D = query.shape
        Hkv, Lk = key.shape[-3], key.shape[-2]
        if Hq != Hkv and not self.enable_gqa:
            raise ValueError(f"{Hq} query heads over {Hkv} kv heads need enable_gqa=True")
        if value.shape != key.shape or key.shape[:-3] != query.shape[:-3]:
            raise ValueError(f"k and v must share one shape with q's leading dims, got {tuple(key.shape)}, "
                             f"{tuple(value.shape)} for q {tuple(query.shape)}")
        B = math.prod(lead)
        if attn_mask is not None:
            mask = attn_mask.expand(*lead, Hq, Lq, Lk).reshape(B, Hq, Lq, Lk)
            out = diffusion_attention(query.reshape(B, Hq, Lq, D), key.reshape(B, Hkv, Lk, D),
                                      value.reshape(B, Hkv, Lk, D), mask, self.scale, float("nan"), True)
            return out.reshape(query.shape)

        def pack(x):  # (..., H, L, D) -> (B * L, H, D)
            return x.reshape(-1, *x.shape[-3:]).transpose(1, 2).reshape(-1, x.shape[-3], x.shape[-1])

        out = flash_attention(pack(query), pack(key), pack(value), _cu_uniform(B, Lq, query.device),
                              _cu_uniform(B, Lk, query.device), False, None, None, self.scale, "AABB")
        return out.reshape(B, Lq, Hq, D).transpose(1, 2).reshape(query.shape)


class CudaPrefillGQA(MojoPrefillGQA):
    """Causal attention over B sequences of S on J, in either GQA layout.
    Causality alone keeps a valid row off the pad keys after it, so this is
    the golden's function, which reads ``cu_q_lens`` no further either."""

    golden_calls = 0

    def forward(self, query, k_cache, v_cache, cu_q_lens, softmax_scale=None):
        _require_int32("cu_q_lens", cu_q_lens)
        if not self.is_causal:
            raise NotImplementedError("MojoPrefillGQA is causal only")
        if _golden_head_dim(CudaPrefillGQA, query.shape[-1]):
            return super().forward(query, k_cache, v_cache, cu_q_lens, softmax_scale)
        B, Hq, S, D = query.shape

        def pack(x):  # (B, H, S, D) -> (B * S, H, D)
            return x.transpose(1, 2).reshape(B * S, x.shape[1], D)

        cu = _cu_uniform(B, S, query.device)
        out = flash_attention(pack(query), pack(k_cache), pack(v_cache), cu, cu, True, None, None, softmax_scale,
                              self.gqa_layout)
        return out.reshape(B, S, Hq, D)
