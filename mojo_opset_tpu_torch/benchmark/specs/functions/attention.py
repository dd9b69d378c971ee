"""Perf descriptors: training SWA attention function (forward + backward).

Counterpart of the JAX package's tests/perf_new/functions/attention.py.
"""

import numpy as np
import torch

from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, mojo_perf, perf_case, tensor
from mojo_opset_tpu_torch.core.functions import MojoSWAFunction

SWA_FN_CASES = [
    perf_case("t2048_w512_bf16", tags=("smoke",), T=2048, B=2, Hq=16, Hkv=4, D=128, W=512),
]


@mojo_perf("SWAFunction", MojoSWAFunction, SWA_FN_CASES)
def swa_function_workload(case):
    p = case.params
    T, B, Hq, Hkv, D, W = p["T"], p["B"], p["Hq"], p["Hkv"], p["D"], p["W"]
    per = T // B

    def cu(spec):
        lens = [per] * (B - 1) + [T - per * (B - 1)]
        return torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])).to(torch.int32)

    return PerfWorkload(
        inputs={
            "query": tensor((T, Hq, D), torch.bfloat16),
            "key": tensor((T, Hkv, D), torch.bfloat16),
            "value": tensor((T, Hkv, D), torch.bfloat16),
            "cu_q_lens": tensor((B + 1,), torch.int32, creator=cu),
            "cu_total_seq_lens": tensor((B + 1,), torch.int32, creator=cu),
        },
        op_kwargs={"local_window_size": W},
        args=("query", "key", "value", "cu_q_lens", "cu_total_seq_lens"),
        run=lambda op, q, k, v, cu1, cu2: op.value_and_grad(q, k, v, cu1, cu2, argnums=(0, 1, 2)),
        flops=8 * T * min(W, per) * Hq * D,
    )
