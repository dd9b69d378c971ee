"""Perf descriptors: sampling and SWA attention.

Counterpart of the JAX package's tests/perf_new/operators/sampling.py.
"""

import numpy as np
import torch

import mojo_opset_tpu_torch as m
from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, literal, mojo_perf, perf_case, tensor

SAMPLE_CASES = [
    perf_case("b8_v32000", tags=("smoke",), B=8, V=32000),
    perf_case("b120_v151936", tags=("smoke", "refrow"), B=120, V=151936),
    perf_case("b15_v155136", tags=("refrow",), B=15, V=155136),
    perf_case("b64_v152064", tags=("full",), B=64, V=152064),
]


@mojo_perf("TopKSampling", m.MojoTopKSampling, SAMPLE_CASES)
def topk_workload(case):
    p = case.params
    return PerfWorkload(
        inputs={"logits": tensor((p["B"], p["V"]), torch.float32)},
        op_kwargs={"top_k": 50},
        args=("logits",),
        read_bytes=p["B"] * p["V"] * 4,
    )


@mojo_perf("TopPSampling", m.MojoTopPSampling, SAMPLE_CASES)
def topp_workload(case):
    p = case.params
    return PerfWorkload(
        inputs={"logits": tensor((p["B"], p["V"]), torch.float32)},
        op_kwargs={"top_p": 0.9},
        args=("logits",),
        read_bytes=p["B"] * p["V"] * 4,
    )


@mojo_perf("ApplyPenaltiesTempurate", m.MojoApplyPenaltiesTempurate, SAMPLE_CASES)
def penalties_workload(case):
    p = case.params
    B, V = p["B"], p["V"]

    def freqs(spec):
        return torch.from_numpy(np.random.default_rng(1).integers(0, 3, (B, V))).to(torch.float32)

    presence = [0.1] * B
    frequency = [0.1] * B
    repetition = [1.1] * B
    temps = [0.7] * B

    def run(op, logits, token_freqs):
        return op(logits, list(token_freqs), presence, frequency, repetition, temps)

    return PerfWorkload(
        inputs={
            "logits": tensor((B, V), torch.float32),
            "token_freqs": tensor((B, V), torch.float32, creator=freqs),
        },
        args=("logits", "token_freqs"),
        run=run,
        read_bytes=2 * B * V * 4,
        write_bytes=B * V * 4,
    )


TOPP_FILTER_CASES = [
    perf_case("b120_v151936_k1000", tags=("smoke", "refrow"), B=120, V=151936, K=1000, P=0.7),
    perf_case("b15_v155136_k100", tags=("refrow",), B=15, V=155136, K=100, P=0.7),
]


@mojo_perf("TopPFilter", m.MojoTopPFilter, TOPP_FILTER_CASES)
def topp_filter_workload(case):
    p = case.params
    return PerfWorkload(
        inputs={"logits": tensor((p["B"], p["V"]), torch.float32)},
        args=("logits", literal(p["P"]), literal(1), literal(p["K"])),
        read_bytes=p["B"] * p["V"] * 4,
    )


REJECT_CASES = [
    perf_case("b15_s3_v155136", tags=("smoke", "refrow"), B=15, S=3, V=155136),
]


def _reject_workload(case):
    p = case.params
    B, S, V = p["B"], p["S"], p["V"]

    def draft_tokens(spec):
        return torch.from_numpy(np.random.default_rng(2).integers(0, V, (B, S))).to(torch.int32)

    def draft_probs(spec):
        return torch.full((B, S), 0.5, dtype=torch.float32)

    def target_probs(spec):
        x = np.random.default_rng(3).random((B, S + 1, V)).astype(np.float32)
        return torch.from_numpy(x / x.sum(-1, keepdims=True))

    return PerfWorkload(
        inputs={
            "target_probs": tensor((B, S + 1, V), torch.float32, creator=target_probs),
            "draft_tokens": tensor((B, S), torch.int32, creator=draft_tokens),
            "draft_probs": tensor((B, S), torch.float32, creator=draft_probs),
        },
        args=("target_probs", "draft_tokens", "draft_probs"),
        read_bytes=B * (S + 1) * V * 4,
    )


mojo_perf("RejectSampling", m.MojoRejectSampling, REJECT_CASES)(_reject_workload)
mojo_perf("JoinProbRejectSampling", m.MojoJoinProbRejectSampling, REJECT_CASES)(_reject_workload)


SWA_CASES = [
    perf_case("t2048_w512_bf16", tags=("smoke",), T=2048, B=2, Hq=16, Hkv=4, D=128, W=512),
    perf_case("t8192_w1024_bf16", tags=("full",), T=8192, B=2, Hq=16, Hkv=4, D=128, W=1024),
]


@mojo_perf("SWA", m.MojoSWA, SWA_CASES)
def swa_workload(case):
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
        flops=4 * T * min(W, per) * Hq * D,
    )
