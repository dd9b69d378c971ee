"""Perf descriptors: activation family.

Counterpart of the JAX package's tests/perf_new/operators/activation.py.
"""

import torch

import mojo_opset_tpu_torch as m
from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, mojo_perf, perf_case, tensor

ACT_CASES = [
    perf_case("x128x128_fp32", tags=("smoke", "refrow"), T=128, D=128, dtype="float32"),
    perf_case("x4096x4096_bf16", tags=("smoke", "full"), T=4096, D=4096, dtype="bfloat16"),
    perf_case("x8192x8192_bf16", tags=("full",), T=8192, D=8192, dtype="bfloat16"),
]


def _act_workload(case):
    T, D = case.params["T"], case.params["D"]
    dt = getattr(torch, case.params["dtype"])
    return PerfWorkload(
        inputs={"x": tensor((T, D), dt)},
        args=("x",),
        read_bytes=T * D * dt.itemsize,
        write_bytes=T * D * dt.itemsize,
    )


mojo_perf("Gelu", m.MojoGelu, ACT_CASES)(_act_workload)
mojo_perf("Silu", m.MojoSilu, ACT_CASES)(_act_workload)


SWIGLU_CASES = [
    perf_case("x256x128_fp32", tags=("smoke", "refrow"), T=256, D=128, dtype="float32"),
    perf_case("x4096x4096_bf16", tags=("smoke", "full"), T=4096, D=4096, dtype="bfloat16"),
]


@mojo_perf("SwiGLU", m.MojoSwiGLU, SWIGLU_CASES)
def swiglu_workload(case):
    T, D = case.params["T"], case.params["D"]
    dt = getattr(torch, case.params["dtype"])
    return PerfWorkload(
        inputs={"gate_out": tensor((T, D), dt), "up_out": tensor((T, D), dt)},
        args=("gate_out", "up_out"),
        read_bytes=2 * T * D * dt.itemsize,
        write_bytes=T * D * dt.itemsize,
    )
