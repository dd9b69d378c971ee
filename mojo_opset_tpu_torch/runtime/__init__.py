from mojo_opset_tpu_torch.runtime.config import MojoConfig, MojoModelConfig
from mojo_opset_tpu_torch.runtime.generation import GeneratorHook, GreedySampler, MojoGenerator, PerfHook
from mojo_opset_tpu_torch.runtime.session import (
    AttentionMetadata,
    FusedDecode,
    KVCaches,
    PagedAttentionGenerationModel,
    PagedAttentionRuntimeState,
)

__all__ = [
    "AttentionMetadata",
    "FusedDecode",
    "GeneratorHook",
    "GreedySampler",
    "KVCaches",
    "MojoConfig",
    "MojoGenerator",
    "MojoModelConfig",
    "PagedAttentionGenerationModel",
    "PagedAttentionRuntimeState",
    "PerfHook",
]
