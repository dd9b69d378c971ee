"""Perf descriptors: quantization / quantized-GEMM family.

Counterpart of the JAX package's tests/perf_new/operators/quant_gemm.py.
"""

import torch

import mojo_opset_tpu_torch as m
from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, mojo_perf, perf_case, tensor
from mojo_opset_tpu_torch.experimental.operators.gemm import MojoQuantBatchGemmReduceSum

QUANT_GEMM_CASES = [
    perf_case("m4096_k4096_n4096", tags=("smoke",), M=4096, K=4096, N=4096),
    perf_case("m8192_k8192_n8192", tags=("full",), M=8192, K=8192, N=8192),
]


@mojo_perf("QuantGemm", m.MojoQuantGemm, QUANT_GEMM_CASES)
def quant_gemm_workload(case):
    p = case.params
    M, K, N = p["M"], p["K"], p["N"]
    return PerfWorkload(
        inputs={
            "input": tensor((M, K), torch.int8),
            "input_scale": tensor((M,), torch.float32),
            "weight": tensor((K, N), torch.int8),
        },
        op_kwargs={"in_features": K, "out_features": N},
        state={"weight": "weight"},
        args=("input", "input_scale"),
        flops=2 * M * K * N,
    )


DYNQ_CASES = [perf_case("t8192_d4096", tags=("smoke",), T=8192, D=4096)]


@mojo_perf("DynamicQuant", m.MojoDynamicQuant, DYNQ_CASES)
def dynamic_quant_workload(case):
    p = case.params
    return PerfWorkload(
        inputs={"input": tensor((p["T"], p["D"]), torch.bfloat16)},
        args=("input",),
        read_bytes=p["T"] * p["D"] * 2,
        write_bytes=p["T"] * p["D"],
    )


STATICQ_CASES = [perf_case("t8192_d4096", tags=("smoke",), T=8192, D=4096)]


@mojo_perf("StaticQuant", m.MojoStaticQuant, STATICQ_CASES)
def static_quant_workload(case):
    p = case.params
    return PerfWorkload(
        inputs={"input": tensor((p["T"], p["D"]), torch.bfloat16)},
        op_kwargs={"input_size": p["D"]},
        args=("input",),
        read_bytes=p["T"] * p["D"] * 2,
        write_bytes=p["T"] * p["D"],
    )


DEQ_CASES = [perf_case("t8192_d4096", tags=("smoke",), T=8192, D=4096)]


@mojo_perf("Dequant", m.MojoDequant, DEQ_CASES)
def dequant_workload(case):
    p = case.params
    T, D = p["T"], p["D"]
    return PerfWorkload(
        inputs={
            "input": tensor((T, D), torch.int8),
            "scale": tensor((T, 1), torch.float32),
        },
        args=("input", "scale"),
        read_bytes=T * D,
        write_bytes=T * D * 2,
    )


def _counts(T, E):
    def build(spec):
        base = T // E
        return torch.tensor([base] * (E - 1) + [T - base * (E - 1)], dtype=torch.int32)

    return build


MOEDQ_CASES = [perf_case("t8192_e16_d4096", tags=("smoke",), T=8192, E=16, D=4096)]


@mojo_perf("MoEDynamicQuant", m.MojoMoEDynamicQuant, MOEDQ_CASES)
def moe_dynamic_quant_workload(case):
    p = case.params
    T, E, D = p["T"], p["E"], p["D"]
    return PerfWorkload(
        inputs={
            "input": tensor((T, D), torch.bfloat16),
            "token_count": tensor((E,), torch.int32, creator=_counts(T, E)),
        },
        op_kwargs={"expert_num": E, "input_size": D},
        args=("input", "token_count"),
        read_bytes=T * D * 2,
        write_bytes=T * D,
    )


DSQ_CASES = [perf_case("t8192_e16_h2048", tags=("smoke",), T=8192, E=16, H=2048)]


@mojo_perf("DequantSwiGLUQuant", m.MojoDequantSwiGLUQuant, DSQ_CASES)
def dequant_swiglu_quant_workload(case):
    p = case.params
    T, E, H = p["T"], p["E"], p["H"]
    return PerfWorkload(
        inputs={
            "x": tensor((T, 2 * H), torch.float32),
            "activation_scale": tensor((T,), torch.float32),
            "token_count": tensor((E,), torch.int32, creator=_counts(T, E)),
        },
        op_kwargs={"expert_num": E, "hidden_size": H},
        args=("x",),
        kwargs={"activation_scale": "activation_scale", "token_count": "token_count"},
        read_bytes=T * 2 * H * 4,
        write_bytes=T * H,
    )


QBGRS_CASES = [
    perf_case("b8_m512_k128_n128", tags=("smoke", "refrow"), B=8, M=512, K=128, N=128),
    perf_case("b4_m1024_k128_n128", tags=("refrow",), B=4, M=1024, K=128, N=128),
]


@mojo_perf("QuantBatchGemmReduceSum", MojoQuantBatchGemmReduceSum, QBGRS_CASES)
def quant_batch_gemm_reduce_sum_workload(case):
    p = case.params
    B, M, K, N = p["B"], p["M"], p["K"], p["N"]
    return PerfWorkload(
        inputs={
            "input": tensor((B, M, K), torch.int8),
            "x1_scale": tensor((B, M), torch.float32),
            "x2_scale": tensor((B, N), torch.float32),
            "weight": tensor((B, K, N), torch.int8),
        },
        op_kwargs={"weight": torch.zeros((B, K, N), dtype=torch.int8)},
        state={"weight": "weight"},
        args=("input", "x1_scale", "x2_scale"),
        flops=2 * B * M * K * N,
    )
