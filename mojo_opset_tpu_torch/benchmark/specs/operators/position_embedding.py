"""Perf descriptors: position embedding family.

Counterpart of the JAX package's tests/perf_new/operators/position_embedding.py.
"""

import numpy as np
import torch

import mojo_opset_tpu_torch as m
from mojo_opset_tpu_torch.benchmark.api import PerfWorkload, literal, mojo_perf, perf_case, tensor
from mojo_opset_tpu_torch.experimental.operators.position_embedding import MojoGridRoPE, MojoRelativeEmbedding

ROPE_CASES = [
    # (B, H, S, D) head-first
    perf_case("b1_h8_s1024_d32", tags=("smoke", "refrow"), B=1, H=8, S=1024, D=32, head_first=True),
    perf_case("b1_h8_s8192_d128", tags=("smoke", "refrow"), B=1, H=8, S=8192, D=128, head_first=True),
    perf_case("b32_h8_s8192_d128", tags=("refrow", "full"), B=32, H=8, S=8192, D=128, head_first=True),
    # packed varlen token-first layout (the serving path)
    perf_case("t1024_h32_d128", tags=("smoke",), T=1024, H=32, D=128, head_first=False),
    perf_case("t8192_h32_d128", tags=("full",), T=8192, H=32, D=128, head_first=False),
]


@mojo_perf("ApplyRoPE", m.MojoApplyRoPE, ROPE_CASES)
def rope_workload(case):
    p = case.params
    H, D = p["H"], p["D"]
    if p["head_first"]:
        B, S = p["B"], p["S"]
        qk_shape = (B, H, S, D)
        # head-first: cos/sin (..., S, D) broadcast over heads
        inputs = {
            "q": tensor(qk_shape, torch.bfloat16),
            "k": tensor(qk_shape, torch.bfloat16),
            "cos": tensor((B, S, D), torch.float32),
            "sin": tensor((B, S, D), torch.float32),
        }
        nbytes = 2 * B * H * S * D * 2
        kwargs = {"head_first": True}
    else:
        T = p["T"]
        inputs = {
            "q": tensor((T, H, D), torch.bfloat16),
            "k": tensor((T, H, D), torch.bfloat16),
            "cos": tensor((T, D), torch.float32),
            "sin": tensor((T, D), torch.float32),
        }
        nbytes = 2 * T * H * D * 2
        kwargs = {"head_first": False}
    return PerfWorkload(
        inputs=inputs,
        args=("q", "k", "cos", "sin"),
        kwargs=kwargs,
        read_bytes=nbytes,
        write_bytes=nbytes,
    )


ROTARY_CASES = [
    perf_case("decode_b64", tags=("smoke",), B=64, D=128),
    perf_case("varlen_t8192", tags=("smoke", "full"), T=8192, D=128),
]


@mojo_perf("RotaryEmbedding", m.MojoRotaryEmbedding, ROTARY_CASES)
def rotary_embedding_workload(case):
    p = case.params
    D = p["D"]
    if "B" in p:
        B = p["B"]

        def pos(spec):
            return torch.arange(B, dtype=torch.int32) * 17

        return PerfWorkload(
            inputs={
                "x": tensor((B, D), torch.bfloat16),
                "position_ids": tensor((B,), torch.int32, creator=pos),
            },
            op_kwargs={"rope_theta": 10000.0, "rope_dim": D},
            args=("x",),
            kwargs={"position_ids": "position_ids"},
            write_bytes=2 * B * D * 4,
        )
    T = p["T"]

    def cu(spec):
        return torch.tensor([0, T // 2, T], dtype=torch.int32)

    def tot(spec):
        return torch.tensor([T // 2, T - T // 2], dtype=torch.int32)

    return PerfWorkload(
        inputs={
            "x": tensor((T, D), torch.bfloat16),
            "cu_q_lens": tensor((3,), torch.int32, creator=cu),
            "total_seq_lens": tensor((2,), torch.int32, creator=tot),
        },
        op_kwargs={"rope_theta": 10000.0, "rope_dim": D},
        args=("x", "cu_q_lens", "total_seq_lens"),
        write_bytes=2 * T * D * 4,
    )


MROPE_CASES = [
    perf_case("t4096_h32_d128", tags=("smoke",), T=4096, H=32, D=128),
]


@mojo_perf("MRoPE", m.MojoMRoPE, MROPE_CASES)
def mrope_workload(case):
    p = case.params
    T, H, D = p["T"], p["H"], p["D"]
    half = D // 2
    return PerfWorkload(
        inputs={
            "query": tensor((T, H * D), torch.bfloat16),
            "key": tensor((T, H * D), torch.bfloat16),
            "cos_table": tensor((3, T, half), torch.float32),
            "sin_table": tensor((3, T, half), torch.float32),
        },
        args=("query", "key", "cos_table", "sin_table", literal([24, 20, 20])),
        read_bytes=2 * T * H * D * 2,
        write_bytes=2 * T * H * D * 2,
    )


VISION_ROPE_CASES = [
    perf_case("t4096_n16_d64", tags=("smoke",), T=4096, N=16, D=64),
]


@mojo_perf("ApplyVisionRoPE2D", m.MojoApplyVisionRoPE2D, VISION_ROPE_CASES)
def vision_rope_workload(case):
    p = case.params
    T, N, D = p["T"], p["N"], p["D"]
    return PerfWorkload(
        inputs={
            "q": tensor((T, N, D), torch.bfloat16),
            "k": tensor((T, N, D), torch.bfloat16),
            "cos": tensor((T, D), torch.float32),
            "sin": tensor((T, D), torch.float32),
        },
        args=("q", "k", "cos", "sin"),
        read_bytes=2 * T * N * D * 2,
        write_bytes=2 * T * N * D * 2,
    )


GRID_ROPE_CASES = [
    perf_case("video_21x30x52_n12_d128", tags=("smoke",), F=21, Hg=30, W=52, N=12, D=128),
]


# GridRoPE takes a list of tables: a custom run wrapper
@mojo_perf("GridRoPE", MojoGridRoPE, GRID_ROPE_CASES)
def grid_rope_workload(case):
    p = case.params
    F, Hg, W, N, D = p["F"], p["Hg"], p["W"], p["N"], p["D"]
    L = F * Hg * W

    def freqs(spec):
        ang = torch.linspace(0.0, 1.0, L * D // 2, dtype=torch.float32).reshape(L, 1, D // 2)
        return torch.polar(torch.ones_like(ang), ang)

    grid = np.asarray([[F, Hg, W]])
    return PerfWorkload(
        inputs={
            "x": tensor((1, L, N, D), torch.bfloat16),
            "freqs": tensor((L, 1, D // 2), torch.complex64, creator=freqs),
        },
        args=("x", "freqs"),
        run=lambda op, x, freqs: op(x, grid, [freqs]),
        read_bytes=L * N * D * 2,
        write_bytes=L * N * D * 2,
    )


REL_EMB_CASES = [
    perf_case("lq1024_lk1024_h64", tags=("smoke",), LQ=1024, LK=1024, H=64),
]


@mojo_perf("RelativeEmbedding", MojoRelativeEmbedding, REL_EMB_CASES)
def relative_embedding_workload(case):
    p = case.params
    LQ, LK, H = p["LQ"], p["LK"], p["H"]
    return PerfWorkload(
        inputs={"emb_weight": tensor((32, H), torch.float32)},
        op_kwargs={"num_buckets": 32, "num_heads": H, "bidirectional": True},
        state={"embedding": "emb_weight"},
        args=(literal(LQ), literal(LK)),
        write_bytes=H * LQ * LK * 4,
    )
