"""Perf descriptors: attention suite.

Counterpart of the JAX package's tests/perf_new/operators/attention.py. The
paged ops' kernel spans are the port's: kernel C's ``paged_decode_kernel``
and ``paged_decode_merge_kernel`` (``csrc/paged_decode.cu``), kernel D's
``paged_prefill_mma`` and ``paged_prefill_fma`` (``csrc/paged_prefill.cu``);
``reduction="sum"`` counts the kernels' time and not the gaps between calls.
The ref tier launches none of them, so its records fall back to the chain.
"""

import numpy as np
import torch

import mojo_opset_tpu_torch as m
from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, mojo_perf, perf_case, profile, tensor


def _block_tables_creator(B, NB):
    def build(spec):
        return torch.arange(B * NB, dtype=torch.int32).reshape(B, NB)

    return build


def _full_lens(B, L):
    def build(spec):
        return torch.full((B,), L, dtype=torch.int32)

    return build


PAGED_DECODE_CASES = [
    perf_case("q8x16x128_ctx128_bf16", tags=("smoke",), B=8, Hq=16, Hkv=4, D=128, bs=32, NB=4),
    perf_case("q8x16x128_ctx4096_bf16", tags=("smoke", "full"), B=8, Hq=16, Hkv=4, D=128, bs=64, NB=64),
    perf_case("q16x32x128_ctx2048_bf16", tags=("full",), B=16, Hq=32, Hkv=8, D=128, bs=64, NB=32),
]


@mojo_perf(
    "PagedDecodeGQA", m.MojoPagedDecodeGQA, PAGED_DECODE_CASES,
    profiling=profile(kernels=("paged_decode*",), reduction="sum"),
)
def paged_decode_workload(case):
    p = case.params
    B, Hq, Hkv, D, bs, NB = p["B"], p["Hq"], p["Hkv"], p["D"], p["bs"], p["NB"]
    N = B * NB
    return PerfWorkload(
        inputs={
            "query": tensor((B, Hq, D), torch.bfloat16),
            "key_cache": tensor((N, Hkv, bs, D), torch.bfloat16),
            "value_cache": tensor((N, Hkv, bs, D), torch.bfloat16),
            "total_seq_lens": tensor((B,), torch.int32, creator=_full_lens(B, bs * NB)),
            "block_tables": tensor((B, NB), torch.int32, creator=_block_tables_creator(B, NB)),
        },
        flops=4 * B * Hq * NB * bs * D,
        read_bytes=2 * N * Hkv * bs * D * 2,
    )


PAGED_PREFILL_CASES = [
    perf_case("t1695x16x128_bs2", tags=("smoke",), T=1695, B=2, Hq=16, Hkv=4, D=128, bs=64),
    perf_case("t4096x16x128_bs2", tags=("full",), T=4096, B=2, Hq=16, Hkv=4, D=128, bs=64),
]


@mojo_perf(
    "PagedPrefillGQA", m.MojoPagedPrefillGQA, PAGED_PREFILL_CASES,
    profiling=profile(kernels=("paged_prefill*",), reduction="sum"),
)
def paged_prefill_workload(case):
    p = case.params
    T, B, Hq, Hkv, D, bs = p["T"], p["B"], p["Hq"], p["Hkv"], p["D"], p["bs"]
    per = T // B
    NB = -(-per // bs)
    N = B * NB

    def cu(spec):
        lens = [per] * (B - 1) + [T - per * (B - 1)]
        return torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])).to(torch.int32)

    return PerfWorkload(
        inputs={
            "query": tensor((T, Hq, D), torch.bfloat16),
            "key_cache": tensor((N, Hkv, bs, D), torch.bfloat16),
            "value_cache": tensor((N, Hkv, bs, D), torch.bfloat16),
            "cu_q_lens": tensor((B + 1,), torch.int32, creator=cu),
            "block_tables": tensor((B, NB), torch.int32, creator=_block_tables_creator(B, NB)),
        },
        flops=2 * 2 * T * (T // B) * Hq * D // 2,
    )


SDPA_CASES = [
    perf_case("b4h16s1024d128", tags=("smoke",), B=4, H=16, S=1024, D=128),
    perf_case("b4h16s4096d128", tags=("full",), B=4, H=16, S=4096, D=128),
]


@mojo_perf("Sdpa", m.MojoSdpa, SDPA_CASES)
def sdpa_workload(case):
    p = case.params
    B, H, S, D = p["B"], p["H"], p["S"], p["D"]
    return PerfWorkload(
        inputs={
            "query": tensor((B, H, S, D), torch.bfloat16),
            "key": tensor((B, H, S, D), torch.bfloat16),
            "value": tensor((B, H, S, D), torch.bfloat16),
        },
        flops=4 * B * H * S * S * D,
    )
