"""Perf descriptors: DeepSeek-V3.2 lightning indexer.

Counterpart of the JAX package's tests/perf_new/operators/indexer.py.
"""

import torch

from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, mojo_perf, perf_case, tensor
from mojo_opset_tpu_torch.experimental.operators.indexer import MojoLightningIndexer

INDEXER_CASES = [
    perf_case("b4_m1024_n4096_h16_k64", tags=("smoke",), B=4, M=1024, N=4096, H=16, K=64),
    perf_case("b1_m4096_n16384_h16_k64", tags=("full",), B=1, M=4096, N=16384, H=16, K=64),
]


@mojo_perf("LightningIndexer", MojoLightningIndexer, INDEXER_CASES)
def lightning_indexer_workload(case):
    p = case.params
    B, M, N, H, K = p["B"], p["M"], p["N"], p["H"], p["K"]
    return PerfWorkload(
        inputs={
            "query": tensor((B, M, H, K), torch.bfloat16),
            "query_scale": tensor((B, M, H), torch.float32),
            "key": tensor((B, N, K), torch.bfloat16),
        },
        args=("query", "query_scale", "key"),
        flops=2 * B * M * N * H * K,
    )
