"""Perf descriptors: normalization family.

Counterpart of the JAX package's tests/perf_new/operators/normalization.py.
"""

import torch

import mojo_opset_tpu_torch as m
from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, mojo_perf, perf_case, tensor

NORM_CASES = [
    perf_case("t32x2048_bf16", tags=("smoke", "refrow"), T=32, D=2048),
    perf_case("t256x128_bf16", tags=("smoke", "refrow"), T=256, D=128),
    perf_case("t128x128_bf16", tags=("refrow",), T=128, D=128),
    perf_case("t4096x4096_bf16", tags=("smoke", "full"), T=4096, D=4096),
    perf_case("t8192x8192_bf16", tags=("full",), T=8192, D=8192),
]


@mojo_perf("RMSNorm", m.MojoRMSNorm, NORM_CASES)
def rmsnorm_workload(case):
    T, D = case.params["T"], case.params["D"]
    return PerfWorkload(
        inputs={
            "hidden": tensor((T, D), torch.bfloat16),
            "weight": tensor((D,), torch.float32),
        },
        op_kwargs={"norm_size": D},
        state={"weight": "weight"},
        args=("hidden",),
        read_bytes=T * D * 2,
        write_bytes=T * D * 2,
    )


@mojo_perf("LayerNorm", m.MojoLayerNorm, NORM_CASES)
def layernorm_workload(case):
    T, D = case.params["T"], case.params["D"]
    return PerfWorkload(
        inputs={"hidden": tensor((T, D), torch.bfloat16)},
        op_kwargs={"norm_size": D},
        args=("hidden",),
        read_bytes=T * D * 2,
        write_bytes=T * D * 2,
    )


@mojo_perf("ResidualAddRMSNorm", m.MojoResidualAddRMSNorm, NORM_CASES)
def residual_add_rmsnorm_workload(case):
    T, D = case.params["T"], case.params["D"]
    return PerfWorkload(
        inputs={
            "hidden": tensor((T, D), torch.bfloat16),
            "residual": tensor((T, D), torch.bfloat16),
        },
        op_kwargs={"norm_size": D},
        read_bytes=2 * T * D * 2,
        write_bytes=2 * T * D * 2,
    )


@mojo_perf("RMSNormQuant", m.MojoRMSNormQuant, NORM_CASES)
def rmsnorm_quant_workload(case):
    T, D = case.params["T"], case.params["D"]
    return PerfWorkload(
        inputs={"hidden": tensor((T, D), torch.bfloat16)},
        op_kwargs={"norm_size": D},
        args=("hidden",),
        read_bytes=T * D * 2,
        write_bytes=T * D,
    )


@mojo_perf("ResidualAddLayerNorm", m.MojoResidualAddLayerNorm, NORM_CASES)
def residual_add_layernorm_workload(case):
    T, D = case.params["T"], case.params["D"]
    return PerfWorkload(
        inputs={
            "hidden": tensor((T, D), torch.bfloat16),
            "residual": tensor((T, D), torch.bfloat16),
        },
        op_kwargs={"norm_size": D},
        read_bytes=2 * T * D * 2,
        write_bytes=2 * T * D * 2,
    )
