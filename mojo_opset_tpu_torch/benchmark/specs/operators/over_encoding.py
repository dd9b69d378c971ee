"""Perf descriptors: over-tokenized encoding (n-gram hash + NF4 embedding).

Counterpart of the JAX package's tests/perf_new/operators/over_encoding.py.
"""

import numpy as np
import torch

import mojo_opset_tpu_torch as m
from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, mojo_perf, perf_case, tensor


def _ids(V):
    def build(spec):
        return torch.from_numpy(np.random.default_rng(0).integers(0, V, spec.shape)).to(torch.int32)

    return build


NGRAM_CASES = [
    perf_case("b8_t1024_g2", tags=("smoke",), B=8, T=1024),
]


@mojo_perf("OverEncodingNGram", m.MojoOverEncodingNGram, NGRAM_CASES)
def ngram_workload(case):
    p = case.params
    B, T = p["B"], p["T"]
    V = 32000
    return PerfWorkload(
        inputs={
            "input_ids": tensor((B, T), torch.int32, creator=_ids(V)),
            "oe_history_input": tensor((B, 2), torch.int32, creator=_ids(V)),
        },
        op_kwargs={
            "ori_vocab_size": V,
            "oe_vocab_sizes": [100003, 100019],
            "oe_grams": [2, 3],
        },
        args=("input_ids", "oe_history_input"),
        read_bytes=B * T * 4,
        write_bytes=B * T * 2 * 4,
    )


OE_CASES = [
    perf_case("b4_t512", tags=("smoke",), B=4, T=512),
]


@mojo_perf("OverEncoding", m.MojoOverEncoding, OE_CASES)
def over_encoding_workload(case):
    p = case.params
    B, T = p["B"], p["T"]
    V, D, OED = 32000, 1024, 256
    return PerfWorkload(
        inputs={
            "input_tensor": tensor((B, T), torch.int32, creator=_ids(V)),
            "oe_history_input": tensor((B, 2), torch.int32, creator=_ids(V)),
        },
        op_kwargs={
            "ori_vocab_size": V,
            "ori_embed_dim": D,
            "oe_embed_dim": OED,
            "oe_vocab_sizes": [100003, 100019],
            "oe_grams": [2, 3],
        },
        args=("input_tensor", "oe_history_input"),
        read_bytes=B * T * (D + 2 * OED) * 2,
        write_bytes=B * T * D * 2,
    )


NF4_CASES = [
    perf_case("t8192_d1024_g64", tags=("smoke",), T=8192, V=100003, D=1024, G=64),
]


@mojo_perf("NF4DequantEmbedding", m.MojoNF4DequantEmbedding, NF4_CASES)
def nf4_embedding_workload(case):
    p = case.params
    T, V, D, G = p["T"], p["V"], p["D"], p["G"]

    def qw(spec):
        return torch.from_numpy(np.random.default_rng(1).integers(-128, 128, spec.shape)).to(torch.int8)

    return PerfWorkload(
        inputs={
            "input": tensor((T,), torch.int32, creator=_ids(V)),
            "qweight": tensor((V, D // 2), torch.int8, creator=qw),
            "scale": tensor((V, D // G), torch.float32),
            "mean": tensor((V, D // G), torch.float32),
        },
        op_kwargs={
            "qweight": torch.zeros((V, D // 2), dtype=torch.int8),
            "scale": torch.ones((V, D // G), dtype=torch.float32),
            "mean": torch.zeros((V, D // G), dtype=torch.float32),
            "group_size": G,
        },
        state={"weight": "qweight", "scale": "scale", "mean": "mean"},
        args=("input",),
        read_bytes=T * D // 2,
        write_bytes=T * D * 2,
    )
