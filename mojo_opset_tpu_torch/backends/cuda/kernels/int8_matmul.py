"""Kernel F: int8 x int8 -> int32 GEMM with the dequant epilogue
(``csrc/int8_matmul.cu``) and its plain PyTorch version.

Replaces the JAX package's ``backends/pallas/kernels/int8_matmul.py:54``
(``int8_scaled_matmul``). ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.core.operators.gemm import QUANT_OUTPUT_DTYPES
from mojo_opset_tpu_torch.core.operators.gemm import quant_matmul_reference as int8_scaled_matmul_plain

launches = 0


def int8_scaled_matmul(
    x: torch.Tensor,
    weight: torch.Tensor,
    input_scale: torch.Tensor,
    weight_scale: torch.Tensor,
    trans_weight: bool,
    output_dtype: torch.dtype,
) -> torch.Tensor:
    """``out[m, n] = (sum_k x[m, k] * w[k, n]) * input_scale[m] *
    weight_scale[n]`` for int8 x (M, K) and w (K, N), or (N, K) with
    ``trans_weight``; fp32 scales (M,) or (M, 1) and (N,).

    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("int8_scaled_matmul", x, weight, input_scale, weight_scale)
    if x.device.type == "cpu":
        return int8_scaled_matmul_plain(x, weight, input_scale, weight_scale, trans_weight, output_dtype)
    return _int8_matmul_kernel(x, weight, input_scale, weight_scale, trans_weight, output_dtype)


def _int8_matmul_kernel(x, weight, input_scale, weight_scale, trans_weight, output_dtype):
    global launches
    build.require(output_dtype in QUANT_OUTPUT_DTYPES, f"output dtype must be one of {QUANT_OUTPUT_DTYPES}")
    build.require(x.ndim == 2 and weight.ndim == 2, "x and weight must be 2-D")
    M, K = x.shape
    N = weight.shape[0] if trans_weight else weight.shape[1]
    build.require(
        tuple(weight.shape) == ((N, K) if trans_weight else (K, N)),
        f"weight {tuple(weight.shape)} does not match x {tuple(x.shape)} (trans_weight={trans_weight})",
    )
    build.require(K % 16 == 0, f"the int8 GEMM takes K % 16 == 0, got K = {K}")
    build.require(trans_weight or N % 16 == 0, f"a (K, N) weight needs N % 16 == 0, got N = {N}")
    build.require_device(x.device, weight, input_scale, weight_scale)
    for name, t in (("x", x), ("weight", weight)):
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
        "mojo_int8_matmul", x.device,
        x.data_ptr(), weight.data_ptr(), input_scale.data_ptr(), weight_scale.data_ptr(), out.data_ptr(),
        M, N, K, int(trans_weight), build.DTYPE_CODES[output_dtype],
    )
    launches += 1
    return out
