from mojo_opset_tpu_torch.core.functions.activation import MojoSiluFunction
from mojo_opset_tpu_torch.core.functions.attention import MojoSWAFunction
from mojo_opset_tpu_torch.core.functions.convolution import MojoCausalConv1dFunction
from mojo_opset_tpu_torch.core.functions.loss import (
    MojoFusedLinearCrossEntropyFunction,
    MojoFusedLinearCrossEntropyLoss,
    fused_linear_cross_entropy,
)
from mojo_opset_tpu_torch.core.functions.normalization import MojoRMSNormFunction
from mojo_opset_tpu_torch.core.functions.position_embedding import MojoApplyRoPEFunction

__all__ = [
    "MojoApplyRoPEFunction",
    "MojoCausalConv1dFunction",
    "MojoFusedLinearCrossEntropyFunction",
    "MojoFusedLinearCrossEntropyLoss",
    "MojoRMSNormFunction",
    "MojoSWAFunction",
    "MojoSiluFunction",
    "fused_linear_cross_entropy",
]
