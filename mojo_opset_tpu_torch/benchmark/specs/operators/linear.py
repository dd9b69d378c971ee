"""Perf descriptors: dense GEMM / grouped GEMM / embedding.

Counterpart of the JAX package's tests/perf_new/operators/linear.py. The
grouped GEMM's weight creator draws from a ``torch.Generator`` seeded 0,
where the JAX package draws from ``PRNGKey(0)``: both are normal samples,
not the same ones.
"""

import numpy as np
import torch

import mojo_opset_tpu_torch as m
from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, mojo_perf, perf_case, tensor

GEMM_CASES = [
    perf_case("m4096_k4096_n4096_bf16", tags=("smoke",), M=4096, K=4096, N=4096),
    perf_case("m8192_k8192_n8192_bf16", tags=("full",), M=8192, K=8192, N=8192),
]


@mojo_perf("Gemm", m.MojoGemm, GEMM_CASES)
def gemm_workload(case):
    p = case.params
    M, K, N = p["M"], p["K"], p["N"]
    return PerfWorkload(
        inputs={
            "input": tensor((M, K), torch.bfloat16),
            "weight": tensor((N, K), torch.bfloat16),
        },
        op_kwargs={"in_features": K, "out_features": N, "bias": False},
        state={"weight": "weight"},
        args=("input",),
        flops=2 * M * K * N,
    )


GROUP_GEMM_CASES = [
    perf_case("in20480x4096_g8_bf16", tags=("smoke", "refrow"), M=20480, K=4096, N=4096, G=8),
    perf_case("in8192x4096_g16_bf16", tags=("full",), M=8192, K=4096, N=4096, G=16),
]


@mojo_perf("GroupGemm", m.MojoGroupGemm, GROUP_GEMM_CASES)
def group_gemm_workload(case):
    p = case.params
    M, K, N, G = p["M"], p["K"], p["N"], p["G"]

    def weight(spec):
        return torch.randn((G, K, N), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)

    def group_list(spec):
        base = M // G
        return torch.tensor([base] * (G - 1) + [M - base * (G - 1)], dtype=torch.int32)

    return PerfWorkload(
        inputs={
            "input": tensor((M, K), torch.bfloat16),
            "weight": tensor((G, K, N), torch.bfloat16, creator=weight),
            "group_list": tensor((G,), torch.int32, creator=group_list),
        },
        op_kwargs={"weight": torch.zeros((G, K, N), dtype=torch.bfloat16)},
        state={"weight": "weight"},
        args=("input", "group_list"),
        flops=2 * M * K * N,
    )


EMB_CASES = [
    perf_case("t8192_v152k_d4096", tags=("smoke",), T=8192, V=152064, D=4096),
]


@mojo_perf("Embedding", m.MojoEmbedding, EMB_CASES)
def embedding_workload(case):
    p = case.params
    T, V, D = p["T"], p["V"], p["D"]

    def ids(spec):
        return torch.from_numpy(np.random.default_rng(0).integers(0, V, (T,))).to(torch.int32)

    return PerfWorkload(
        inputs={
            "input_ids": tensor((T,), torch.int32, creator=ids),
            "weight": tensor((V, D), torch.bfloat16),
        },
        op_kwargs={"num_embeddings": V, "embedding_dim": D, "dtype": torch.bfloat16},
        state={"weight": "weight"},
        args=("input_ids",),
        read_bytes=T * D * 2,
        write_bytes=T * D * 2,
    )
