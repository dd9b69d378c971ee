from mojo_opset_tpu_torch.runtime.compile_cache import CompiledStepPool, round_up_bucket
from mojo_opset_tpu_torch.runtime.config import (
    AFDRole,
    MojoConfig,
    MojoModelConfig,
    MojoParallelConfig,
    MojoRunTimeConfig,
)
from mojo_opset_tpu_torch.runtime.generation import (
    GeneratorHook,
    GreedySampler,
    MojoGenerator,
    MojoSampler,
    PerfHook,
    TopKSampler,
)
from mojo_opset_tpu_torch.runtime.session import (
    AttentionMetadata,
    FusedDecode,
    KVCaches,
    PagedAttentionGenerationModel,
    PagedAttentionRuntimeState,
)
from mojo_opset_tpu_torch.runtime.speculative import SpeculativeDecoder
from mojo_opset_tpu_torch.runtime.continuous import (
    ContinuousBatchingGenerator,
    SpeculativeContinuousBatchingGenerator,
)

__all__ = [
    "AFDRole",
    "AttentionMetadata",
    "CompiledStepPool",
    "ContinuousBatchingGenerator",
    "FusedDecode",
    "GeneratorHook",
    "GreedySampler",
    "KVCaches",
    "MojoConfig",
    "MojoGenerator",
    "MojoModelConfig",
    "MojoParallelConfig",
    "MojoRunTimeConfig",
    "MojoSampler",
    "PagedAttentionGenerationModel",
    "PagedAttentionRuntimeState",
    "PerfHook",
    "SpeculativeContinuousBatchingGenerator",
    "SpeculativeDecoder",
    "TopKSampler",
    "round_up_bucket",
]
