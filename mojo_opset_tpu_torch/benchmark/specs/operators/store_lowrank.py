"""Perf descriptors: low-rank latent state store.

Counterpart of the JAX package's tests/perf_new/operators/store_lowrank.py.
"""

import torch

from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, literal, mojo_perf, perf_case, tensor
from mojo_opset_tpu_torch.experimental.operators.kv_cache import MojoStoreLowrank

STORE_LOWRANK_CASES = [
    perf_case("t4096_n1_d512", tags=("smoke",), T=4096, B=8, N=1, S=1024, D=512),
]


@mojo_perf("StoreLowrank", MojoStoreLowrank, STORE_LOWRANK_CASES)
def store_lowrank_workload(case):
    p = case.params
    T, B, N, S, D = p["T"], p["B"], p["N"], p["S"], p["D"]

    def blocks(spec):
        return (torch.arange(T, dtype=torch.int32) // S) % B

    def tokens(spec):
        return torch.arange(T, dtype=torch.int32) % S

    return PerfWorkload(
        inputs={
            "label_cache": tensor((B, N, S, D), torch.bfloat16),
            "key_lr": tensor((T, N, D), torch.bfloat16),
            "block_idxs": tensor((T,), torch.int32, creator=blocks),
            "token_idxs": tensor((T,), torch.int32, creator=tokens),
        },
        args=("label_cache", "key_lr", "block_idxs", "token_idxs", literal(4096)),
        write_bytes=T * N * D * 2,
        thread={"label_cache": 0},
    )
