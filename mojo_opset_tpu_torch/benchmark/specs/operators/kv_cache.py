"""Perf descriptors: paged KV-cache store / dequant family.

Counterpart of the JAX package's tests/perf_new/operators/kv_cache.py. The
stores write their caches in place and return them; ``thread`` hands them
back to the next call of a timing chain, so no call copies a cache.
"""

import numpy as np
import torch

import mojo_opset_tpu_torch as m
from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, literal, mojo_perf, perf_case, profile, tensor
from mojo_opset_tpu_torch.experimental.operators.kv_cache import (
    MojoDequantFromPagedKVCache,
    MojoStorePagedKVCacheC8,
    MojoStorePagedMLAKVCache,
)

STORE_KV_CASES = [
    # decode rows: one token a sequence at b in {1, 4, 16}
    perf_case("decode_b1", tags=("smoke", "refrow"), T=1, Hkv=4, D=128, bs=32, NB=12, decode=True),
    perf_case("decode_b4", tags=("smoke", "refrow"), T=4, Hkv=4, D=128, bs=32, NB=12, decode=True),
    perf_case("decode_b16", tags=("smoke", "refrow"), T=16, Hkv=4, D=128, bs=32, NB=12, decode=True),
    perf_case("decode_b16_h8", tags=("smoke",), T=16, Hkv=8, D=128, bs=64, NB=32, decode=True),
    perf_case("prefill_t4096", tags=("smoke", "full"), T=4096, Hkv=8, D=128, bs=64, NB=64, decode=False),
    perf_case("decode_b16_nhd", tags=("smoke",), T=16, Hkv=8, D=128, bs=64, NB=32, decode=True, layout="NHD"),
    perf_case("prefill_t4096_nhd", tags=("smoke", "full"), T=4096, Hkv=8, D=128, bs=64, NB=64, decode=False,
              layout="NHD"),
]


def _store_tables(B, N, NB, bs, T, decode):
    def bt(spec):
        return torch.arange(N, dtype=torch.int32).reshape(B, -1)[:, :NB]

    def ctx(spec):
        return torch.full((B,), bs, dtype=torch.int32) if decode else torch.zeros((B,), dtype=torch.int32)

    def cu(spec):
        return torch.tensor([0, T], dtype=torch.int32)

    return bt, ctx, cu


@mojo_perf(
    "StorePagedKVCache", m.MojoStorePagedKVCache, STORE_KV_CASES,
    # the store is plain PyTorch (index, where and copy kernels): every
    # device kernel of a call is the store's; sum, not span, so the gaps
    # between calls never count
    profiling=profile(kernels=("*",), reduction="sum"),
)
def store_kv_workload(case):
    p = case.params
    T, Hkv, D, bs, NB = p["T"], p["Hkv"], p["D"], p["bs"], p["NB"]
    B = T if p["decode"] else 1
    N = max(B, 1) * NB
    bt, ctx, cu = _store_tables(B, N, NB, bs, T, p["decode"])
    layout = p.get("layout", "HND")
    cache_shape = (N, bs, Hkv, D) if layout == "NHD" else (N, Hkv, bs, D)
    inputs = {
        "key_states": tensor((T, Hkv, D), torch.bfloat16),
        "value_states": tensor((T, Hkv, D), torch.bfloat16),
        "key_cache": tensor(cache_shape, torch.bfloat16),
        "value_cache": tensor(cache_shape, torch.bfloat16),
        "block_table": tensor((B, NB), torch.int32, creator=bt),
        "context_kv_lens": tensor((B,), torch.int32, creator=ctx),
    }
    kwargs = {}
    if not p["decode"]:
        inputs["cu_q_lens"] = tensor((2,), torch.int32, creator=cu)
        args = ("key_states", "value_states", "key_cache", "value_cache",
                "block_table", "cu_q_lens", "context_kv_lens")
    else:
        args = ("key_states", "value_states", "key_cache", "value_cache", "block_table")
        kwargs = {"context_kv_lens": "context_kv_lens"}
    return PerfWorkload(
        inputs=inputs,
        op_kwargs={"kv_layout": layout},
        args=args,
        kwargs=kwargs,
        write_bytes=2 * T * Hkv * D * 2,
        thread={"key_cache": 0, "value_cache": 1},
    )


STORE_MLA_CASES = [
    perf_case("decode_b16_r512", tags=("smoke",), T=16, R=512, DR=64, bs=64, NB=32, decode=True),
    perf_case("prefill_t4096_r512", tags=("smoke", "full"), T=4096, R=512, DR=64, bs=64, NB=64, decode=False),
]


@mojo_perf("StorePagedMLAKVCache", MojoStorePagedMLAKVCache, STORE_MLA_CASES)
def store_mla_kv_workload(case):
    p = case.params
    T, R, DR, bs, NB = p["T"], p["R"], p["DR"], p["bs"], p["NB"]
    B = T if p["decode"] else 1
    N = max(B, 1) * NB
    bt, ctx, cu = _store_tables(B, N, NB, bs, T, p["decode"])
    inputs = {
        "compressed_kv_states": tensor((T, R), torch.bfloat16),
        "k_pe_states": tensor((T, DR), torch.bfloat16),
        "compressed_kv_cache": tensor((N, 1, bs, R), torch.bfloat16),
        "k_pe_cache": tensor((N, 1, bs, DR), torch.bfloat16),
        "block_table": tensor((B, NB), torch.int32, creator=bt),
        "context_kv_lens": tensor((B,), torch.int32, creator=ctx),
    }
    if not p["decode"]:
        inputs["cu_q_lens"] = tensor((2,), torch.int32, creator=cu)
        args = ("compressed_kv_states", "k_pe_states", "compressed_kv_cache",
                "k_pe_cache", "block_table", "cu_q_lens", "context_kv_lens")
    else:
        args = ("compressed_kv_states", "k_pe_states", "compressed_kv_cache",
                "k_pe_cache", "block_table", literal(None), "context_kv_lens")
    return PerfWorkload(
        inputs=inputs,
        args=args,
        write_bytes=T * (R + DR) * 2,
        thread={"compressed_kv_cache": 0, "k_pe_cache": 1},
    )


STORE_C8_CASES = [
    perf_case("decode_b16", tags=("smoke",), T=16, Hkv=8, D=128, bs=64, NB=32, decode=True),
    perf_case("prefill_t4096", tags=("smoke", "full"), T=4096, Hkv=8, D=128, bs=64, NB=64, decode=False),
]


def _ones_scale(spec):
    return torch.ones(spec.shape, dtype=torch.float32)


@mojo_perf("StorePagedKVCacheC8", MojoStorePagedKVCacheC8, STORE_C8_CASES)
def store_c8_workload(case):
    p = case.params
    T, Hkv, D, bs, NB = p["T"], p["Hkv"], p["D"], p["bs"], p["NB"]
    B = T if p["decode"] else 1
    N = max(B, 1) * NB
    bt, ctx, cu = _store_tables(B, N, NB, bs, T, p["decode"])
    inputs = {
        "key_states": tensor((T, Hkv, D), torch.bfloat16),
        "value_states": tensor((T, Hkv, D), torch.bfloat16),
        "key_cache": tensor((N, Hkv, bs, D), torch.int8),
        "value_cache": tensor((N, Hkv, bs, D), torch.int8),
        "key_scale": tensor((Hkv, D), torch.float32, creator=_ones_scale),
        "value_scale": tensor((Hkv, D), torch.float32, creator=_ones_scale),
        "block_table": tensor((B, NB), torch.int32, creator=bt),
        "context_kv_lens": tensor((B,), torch.int32, creator=ctx),
    }
    if not p["decode"]:
        inputs["cu_q_lens"] = tensor((2,), torch.int32, creator=cu)
        args = ("key_states", "value_states", "key_cache", "value_cache",
                "key_scale", "value_scale", "block_table", "cu_q_lens", "context_kv_lens")
    else:
        args = ("key_states", "value_states", "key_cache", "value_cache",
                "key_scale", "value_scale", "block_table", literal(None), "context_kv_lens")
    return PerfWorkload(
        inputs=inputs,
        args=args,
        write_bytes=2 * T * Hkv * D,
        thread={"key_cache": 0, "value_cache": 1},
    )


DEQUANT_KV_CASES = [
    perf_case("b4_ctx1024", tags=("smoke",), B=4, CTX=1024, Hkv=8, D=128, bs=64),
]


@mojo_perf("DequantFromPagedKVCache", MojoDequantFromPagedKVCache, DEQUANT_KV_CASES)
def dequant_from_kv_workload(case):
    p = case.params
    B, CTX, Hkv, D, bs = p["B"], p["CTX"], p["Hkv"], p["D"], p["bs"]
    NB = CTX // bs
    N = B * NB
    total = B * CTX

    def bt(spec):
        return torch.arange(N, dtype=torch.int32).reshape(B, NB)

    # the op reads context_lengths on the host -> a literal
    lens = np.full((B,), CTX, np.int32)
    return PerfWorkload(
        inputs={
            "key": tensor((total, Hkv, D), torch.bfloat16),
            "value": tensor((total, Hkv, D), torch.bfloat16),
            "key_cache": tensor((N, Hkv, bs, D), torch.int8),
            "value_cache": tensor((N, Hkv, bs, D), torch.int8),
            "key_cache_scale": tensor((Hkv, D), torch.float32, creator=_ones_scale),
            "value_cache_scale": tensor((Hkv, D), torch.float32, creator=_ones_scale),
            "block_tables": tensor((B, NB), torch.int32, creator=bt),
        },
        args=(),
        kwargs={
            "key": "key", "value": "value",
            "key_cache": "key_cache", "key_cache_scale": "key_cache_scale",
            "value_cache": "value_cache", "value_cache_scale": "value_cache_scale",
            "context_lengths": literal(lens), "max_context_len": literal(CTX),
            "block_tables": "block_tables",
        },
        read_bytes=2 * total * Hkv * D,
        write_bytes=2 * total * Hkv * D * 2,
    )
