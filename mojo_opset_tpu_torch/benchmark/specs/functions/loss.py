"""Perf descriptors: fused linear + cross-entropy loss.

Counterpart of the JAX package's tests/perf_new/functions/loss.py.
"""

import numpy as np
import torch

from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, mojo_perf, perf_case, tensor
from mojo_opset_tpu_torch.core.functions import MojoFusedLinearCrossEntropyLoss

FLCE_CASES = [
    perf_case("t4096_h4096_v32000", tags=("smoke",), T=4096, H=4096, V=32000),
    perf_case("t8192_h4096_v152064", tags=("full",), T=8192, H=4096, V=152064),
]


@mojo_perf("FusedLinearCrossEntropyLoss", MojoFusedLinearCrossEntropyLoss, FLCE_CASES)
def flce_workload(case):
    p = case.params
    T, H, V = p["T"], p["H"], p["V"]

    def labels(spec):
        return torch.from_numpy(np.random.default_rng(0).integers(0, V, (T,))).to(torch.int32)

    return PerfWorkload(
        inputs={
            "lin_weight": tensor((V, H), torch.bfloat16),
            "input_tensor": tensor((T, H), torch.bfloat16),
            "target": tensor((T,), torch.int32, creator=labels),
        },
        args=("lin_weight", "input_tensor", "target"),
        flops=2 * T * H * V,
    )
