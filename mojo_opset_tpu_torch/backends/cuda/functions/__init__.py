from mojo_opset_tpu_torch.backends.cuda.functions.activation import CudaSiluFunction, SiluVJP
from mojo_opset_tpu_torch.backends.cuda.functions.attention import CudaSWAFunction, FlashSWA, flash_attention
from mojo_opset_tpu_torch.backends.cuda.functions.diffusion_attention import (
    CudaDiffusionAttentionFunction,
    FlashDiffusion,
    diffusion_attention,
)
from mojo_opset_tpu_torch.backends.cuda.functions.loss import (
    CudaFusedLinearCrossEntropyFunction,
    CudaFusedLinearCrossEntropyLoss,
    FlceVJP,
)
from mojo_opset_tpu_torch.backends.cuda.functions.normalization import CudaRMSNormFunction, RMSNormVJP
from mojo_opset_tpu_torch.backends.cuda.functions.position_embedding import CudaApplyRoPEFunction, RoPEVJP

__all__ = [
    "CudaApplyRoPEFunction",
    "CudaDiffusionAttentionFunction",
    "CudaFusedLinearCrossEntropyFunction",
    "CudaFusedLinearCrossEntropyLoss",
    "CudaRMSNormFunction",
    "CudaSWAFunction",
    "CudaSiluFunction",
    "FlashDiffusion",
    "FlashSWA",
    "FlceVJP",
    "RMSNormVJP",
    "RoPEVJP",
    "SiluVJP",
    "diffusion_attention",
    "flash_attention",
]
