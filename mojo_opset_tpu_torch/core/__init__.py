from mojo_opset_tpu_torch.core.function import MojoFunction
from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.registry import BackendNotAvailable, MojoBackendRegistry

__all__ = ["BackendNotAvailable", "MojoBackendRegistry", "MojoFunction", "MojoOperator"]
