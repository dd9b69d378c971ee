"""Kernel wrappers: each module holds one kernel's launcher, its plain
PyTorch version and its ``launches`` counter."""

from mojo_opset_tpu_torch.backends.cuda.kernels import (
    group_gemm,
    int4_matmul,
    int8_matmul,
    mla_decode,
    norms,
    paged_decode,
    paged_prefill,
    rmsnorm_quant,
    rope,
)

ALL = (norms, rope, paged_decode, paged_prefill, rmsnorm_quant, int8_matmul, int4_matmul, group_gemm, mla_decode)


def reset_launch_counts() -> None:
    for module in ALL:
        module.launches = 0


def launch_counts() -> dict[str, int]:
    return {module.__name__.rsplit(".", 1)[-1]: module.launches for module in ALL}
