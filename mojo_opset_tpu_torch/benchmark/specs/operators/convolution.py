"""Perf descriptors: causal convolution (Mamba-style state update).

Counterpart of the JAX package's tests/perf_new/operators/convolution.py.

The JAX descriptor passes ``"silu"`` as a bare string, which its
``PerfWorkload`` reads as an input's name and refuses (ROADMAP.md queue 3,
"JAX-side notes"); here it is a literal.
"""

import torch

import mojo_opset_tpu_torch as m
from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, literal, mojo_perf, perf_case, tensor

CONV_UPDATE_CASES = [
    perf_case("decode_b64_d4096_w4", tags=("smoke",), B=64, D=4096, T=1, W=4),
    perf_case("chunk_b8_d4096_t64_w4", tags=("smoke", "full"), B=8, D=4096, T=64, W=4),
]


@mojo_perf("CausalConv1dUpdateState", m.MojoCausalConv1dUpdateState, CONV_UPDATE_CASES)
def conv_update_workload(case):
    p = case.params
    B, D, T, W = p["B"], p["D"], p["T"], p["W"]
    return PerfWorkload(
        inputs={
            "hidden_states": tensor((B, D, T), torch.bfloat16),
            "conv_state": tensor((B, D, W - 1), torch.bfloat16),
            "weight": tensor((D, W), torch.bfloat16),
        },
        args=("hidden_states", "conv_state", "weight"),
        kwargs={"activation": literal("silu")},
        read_bytes=B * D * (T + W - 1) * 2,
        write_bytes=B * D * (T + W - 1) * 2,
        thread={"conv_state": 1},
    )
