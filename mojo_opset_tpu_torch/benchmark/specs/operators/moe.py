"""Perf descriptors: MoE pipeline.

Counterpart of the JAX package's tests/perf_new/operators/moe.py.
"""

import torch

import mojo_opset_tpu_torch as m
from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, mojo_perf, perf_case, tensor

MOE_CASES = [
    perf_case("t4096_e64_k4_h2048_i768", tags=("smoke",), T=4096, E=64, K=4, H=2048, I=768),
    perf_case("t8192_e128_k8_h4096_i1536", tags=("full",), T=8192, E=128, K=8, H=4096, I=1536),
]


@mojo_perf("MoE", m.MojoMoE, MOE_CASES)
def moe_workload(case):
    p = case.params
    return PerfWorkload(
        inputs={"hidden": tensor((p["T"], p["H"]), torch.bfloat16)},
        op_kwargs={
            "num_experts": p["E"], "top_k": p["K"], "hidden_size": p["H"],
            "intermediate_size": p["I"], "dtype": torch.bfloat16,
        },
        args=("hidden",),
        flops=2 * 3 * p["T"] * p["K"] * p["H"] * p["I"],
    )


GATING_CASES = [perf_case("t8192_e128_k8", tags=("smoke",), T=8192, E=128, K=8)]


@mojo_perf("MoEGating", m.MojoMoEGating, GATING_CASES)
def moe_gating_workload(case):
    p = case.params
    T, E, K = p["T"], p["E"], p["K"]
    return PerfWorkload(
        inputs={
            "hidden": tensor((T, 2048), torch.bfloat16),
            "gate_weight": tensor((2048, E), torch.float32),
        },
        op_kwargs={"num_experts": E, "top_k": K, "hidden_size": 2048},
        state={"gate_weight": "gate_weight"},
        args=("hidden",),
        flops=2 * T * 2048 * E,
    )
