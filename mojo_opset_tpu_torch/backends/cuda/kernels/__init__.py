"""Kernel wrappers: each module holds one kernel's launcher, its plain
PyTorch version and its ``launches`` counter; kernels J (``flash_swa``) and
O (``flash_diffusion``) have three entry points, kernel N (``flce``) four
and kernel L (``silu_vjp``) two, each with its own counter."""

from mojo_opset_tpu_torch.backends.cuda.kernels import (
    flash_diffusion,
    flash_swa,
    flce,
    group_gemm,
    int4_matmul,
    int8_matmul,
    mla_decode,
    norms,
    paged_decode,
    paged_prefill,
    rmsnorm_quant,
    rmsnorm_vjp,
    rope,
    rope_head_first,
    silu_vjp,
)

ALL = (norms, rope, paged_decode, paged_prefill, rmsnorm_quant, int8_matmul, int4_matmul, group_gemm, mla_decode,
       rmsnorm_vjp, rope_head_first)

# (name, module, counter attribute) of every entry point
COUNTERS = [(module.__name__.rsplit(".", 1)[-1], module, "launches") for module in ALL] + [
    ("flash_swa_fwd", flash_swa, "launches"), ("flash_swa_dq", flash_swa, "launches_dq"),
    ("flash_swa_dkv", flash_swa, "launches_dkv"), ("silu_fwd", silu_vjp, "launches"),
    ("silu_bwd", silu_vjp, "launches_bwd"), ("flce_stats", flce, "launches"), ("flce_dz", flce, "launches_dz"),
    ("flce_dx", flce, "launches_dx"), ("flce_dw", flce, "launches_dw"),
    ("flash_diffusion_fwd", flash_diffusion, "launches"), ("flash_diffusion_dq", flash_diffusion, "launches_dq"),
    ("flash_diffusion_dkv", flash_diffusion, "launches_dkv")]


def reset_launch_counts() -> None:
    for _, module, attr in COUNTERS:
        setattr(module, attr, 0)


def launch_counts() -> dict[str, int]:
    return {name: getattr(module, attr) for name, module, attr in COUNTERS}
