"""Perf descriptors: training causal conv1d function (forward + backward).

Counterpart of the JAX package's tests/perf_new/functions/convolution.py.

The JAX descriptor passes ``"silu"`` as a bare string, which its
``PerfWorkload`` reads as an input's name and refuses (ROADMAP.md queue 3,
"JAX-side notes"); here it is a literal.
"""

import torch

from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, literal, mojo_perf, perf_case, tensor
from mojo_opset_tpu_torch.core.functions import MojoCausalConv1dFunction

CONV_FN_CASES = [
    perf_case("b8_t2048_d2048_w4", tags=("smoke",), B=8, T=2048, D=2048, W=4),
]


@mojo_perf("CausalConv1dFunction", MojoCausalConv1dFunction, CONV_FN_CASES)
def causal_conv1d_function_workload(case):
    p = case.params
    B, T, D, W = p["B"], p["T"], p["D"], p["W"]
    return PerfWorkload(
        inputs={
            "x": tensor((B, T, D), torch.bfloat16),
            "weight": tensor((D, W), torch.bfloat16),
        },
        args=("x", "weight"),
        kwargs={"activation": literal("silu")},
        run=lambda op, x, w, **kw: op.value_and_grad(x, w, argnums=(0, 1), **kw),
        read_bytes=2 * B * T * D * 2,
        write_bytes=2 * B * T * D * 2,
    )
