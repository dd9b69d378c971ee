from mojo_opset_tpu_torch.backends.cuda.functions.activation import CudaSiluFunction, SiluVJP
from mojo_opset_tpu_torch.backends.cuda.functions.attention import CudaSWAFunction, FlashSWA, flash_attention
from mojo_opset_tpu_torch.backends.cuda.functions.normalization import CudaRMSNormFunction, RMSNormVJP
from mojo_opset_tpu_torch.backends.cuda.functions.position_embedding import CudaApplyRoPEFunction, RoPEVJP

__all__ = [
    "CudaApplyRoPEFunction",
    "CudaRMSNormFunction",
    "CudaSWAFunction",
    "CudaSiluFunction",
    "FlashSWA",
    "RMSNormVJP",
    "RoPEVJP",
    "SiluVJP",
    "flash_attention",
]
