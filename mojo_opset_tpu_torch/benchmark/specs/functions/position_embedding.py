"""Perf descriptors: training RoPE function (forward + backward).

Counterpart of the JAX package's tests/perf_new/functions/position_embedding.py.
"""

import torch

from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, mojo_perf, perf_case, tensor
from mojo_opset_tpu_torch.core.functions import MojoApplyRoPEFunction

ROPE_FN_CASES = [
    perf_case("b4_h32_s2048_d128", tags=("smoke",), B=4, H=32, S=2048, D=128),
]


@mojo_perf("ApplyRoPEFunction", MojoApplyRoPEFunction, ROPE_FN_CASES)
def rope_function_workload(case):
    p = case.params
    B, H, S, D = p["B"], p["H"], p["S"], p["D"]
    return PerfWorkload(
        inputs={
            "q": tensor((B, H, S, D), torch.bfloat16),
            "k": tensor((B, H, S, D), torch.bfloat16),
            "cos": tensor((B, S, D), torch.float32),
            "sin": tensor((B, S, D), torch.float32),
        },
        args=("q", "k", "cos", "sin"),
        run=lambda op, q, k, cos, sin: op.value_and_grad(q, k, cos, sin, argnums=(0, 1)),
        read_bytes=2 * B * H * S * D * 2,
        write_bytes=2 * B * H * S * D * 2,
    )
