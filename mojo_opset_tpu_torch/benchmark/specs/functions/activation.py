"""Perf descriptors: training activation functions (forward + backward).

Counterpart of the JAX package's tests/perf_new/functions/activation.py.
"""

import torch

from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, mojo_perf, perf_case, tensor
from mojo_opset_tpu_torch.core.functions import MojoSiluFunction

ACT_FN_CASES = [
    perf_case("t4096x4096_bf16", tags=("smoke",), T=4096, D=4096),
    perf_case("t8192x8192_bf16", tags=("full",), T=8192, D=8192),
]


@mojo_perf("SiluFunction", MojoSiluFunction, ACT_FN_CASES)
def silu_function_workload(case):
    T, D = case.params["T"], case.params["D"]
    return PerfWorkload(
        inputs={"x": tensor((T, D), torch.bfloat16)},
        args=("x",),
        run=lambda op, x: op.value_and_grad(x),
        read_bytes=2 * T * D * 2,
        write_bytes=2 * T * D * 2,
    )
