from mojo_opset_tpu_torch.core.functions.attention import MojoSWAFunction
from mojo_opset_tpu_torch.core.functions.loss import (
    MojoFusedLinearCrossEntropyFunction,
    MojoFusedLinearCrossEntropyLoss,
    fused_linear_cross_entropy,
)

__all__ = [
    "MojoFusedLinearCrossEntropyFunction",
    "MojoFusedLinearCrossEntropyLoss",
    "MojoSWAFunction",
    "fused_linear_cross_entropy",
]
