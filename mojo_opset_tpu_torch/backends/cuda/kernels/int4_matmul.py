"""Kernel G: packed-int4 x int8 -> int32 GEMM with the dequant epilogue
(``csrc/int4_matmul.cu``) and its plain PyTorch version.

Replaces the JAX package's ``backends/pallas/kernels/int4_matmul.py:85``
(``int4_scaled_matmul``). ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.core.operators.gemm import (
    INT4_BLOCK,
    QUANT_OUTPUT_DTYPES,
    quant_matmul_reference,
    unpack_int4_rows,
)

launches = 0


def int4_scaled_matmul_plain(x, w_packed, input_scale, weight_scale, output_dtype):
    """Unpack, then the int8 golden (exact int32 sums, fp32 epilogue)."""
    return quant_matmul_reference(x, unpack_int4_rows(w_packed), input_scale, weight_scale, True, output_dtype)


def int4_scaled_matmul(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    input_scale: torch.Tensor,
    weight_scale: torch.Tensor,
    output_dtype: torch.dtype,
) -> torch.Tensor:
    """``out[m, n] = (sum_k x[m, k] * W[n, k]) * input_scale[m] *
    weight_scale[n]`` for int8 x (M, K) and W unpacked from ``w_packed``,
    int8 (N // 2, K) in the ``pack_int4_rows`` layout; fp32 scales (M,) or
    (M, 1) and (N,).

    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("int4_scaled_matmul", x, w_packed, input_scale, weight_scale)
    if x.device.type == "cpu":
        return int4_scaled_matmul_plain(x, w_packed, input_scale, weight_scale, output_dtype)
    return _int4_matmul_kernel(x, w_packed, input_scale, weight_scale, output_dtype)


def _int4_matmul_kernel(x, w_packed, input_scale, weight_scale, output_dtype):
    global launches
    build.require(output_dtype in QUANT_OUTPUT_DTYPES, f"output dtype must be one of {QUANT_OUTPUT_DTYPES}")
    build.require(x.ndim == 2 and w_packed.ndim == 2, "x and w_packed must be 2-D")
    M, K = x.shape
    N = w_packed.shape[0] * 2
    build.require(w_packed.shape[1] == K, f"w_packed {tuple(w_packed.shape)} does not match x {tuple(x.shape)}")
    build.require(N % INT4_BLOCK == 0, f"the int4 GEMM takes N % {INT4_BLOCK} == 0, got N = {N}")
    build.require(K % 16 == 0, f"the int4 GEMM takes K % 16 == 0, got K = {K}")
    build.require_device(x.device, w_packed, input_scale, weight_scale)
    for name, t in (("x", x), ("w_packed", w_packed)):
        build.require(
            t.dtype == torch.int8 and t.is_contiguous() and t.data_ptr() % 16 == 0,
            f"{name} must be contiguous 16-byte aligned int8, got {t.dtype}",
        )
    for name, t, n in (("input_scale", input_scale, M), ("weight_scale", weight_scale, N)):
        build.require(
            t.dtype == torch.float32 and t.numel() == n and t.is_contiguous(),
            f"{name} must be contiguous float32 with {n} values, got {t.dtype} {tuple(t.shape)}",
        )
    out = torch.empty((M, N), dtype=output_dtype, device=x.device)
    build.launch(
        "mojo_int4_matmul", x.device,
        x.data_ptr(), w_packed.data_ptr(), input_scale.data_ptr(), weight_scale.data_ptr(), out.data_ptr(),
        M, N, K, build.DTYPE_CODES[output_dtype],
    )
    launches += 1
    return out
