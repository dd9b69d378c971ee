from mojo_opset_tpu_torch.runtime.compile_cache import CompiledStepPool, round_up_bucket
from mojo_opset_tpu_torch.runtime.config import (
    AFDRole,
    MojoConfig,
    MojoDynamicConfig,
    MojoModelConfig,
    MojoParallelConfig,
    MojoRunTimeConfig,
)
from mojo_opset_tpu_torch.runtime.generation import (
    DumpHook,
    GeneratorHook,
    GreedySampler,
    MojoGenerator,
    MojoSampler,
    MojoSession,
    PerfHook,
    PerfMojoGenerator,
    TopKSampler,
)
from mojo_opset_tpu_torch.runtime.session import (
    AttentionMetadata,
    FusedDecode,
    KVCaches,
    PagedAttentionGenerationModel,
    PagedAttentionRuntimeState,
)
from mojo_opset_tpu_torch.runtime.comm_context import MojoComputeCommContext, MojoSymmetricMemoryManager
from mojo_opset_tpu_torch.runtime.parallel import (
    dp_allreduce,
    dp_gather,
    dp_scatter,
    merge_group_and_share_ffn,
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
    "DumpHook",
    "FusedDecode",
    "GeneratorHook",
    "GreedySampler",
    "KVCaches",
    "MojoComputeCommContext",
    "MojoConfig",
    "MojoDynamicConfig",
    "MojoGenerator",
    "MojoModelConfig",
    "MojoParallelConfig",
    "MojoRunTimeConfig",
    "MojoSampler",
    "MojoSession",
    "MojoSymmetricMemoryManager",
    "PagedAttentionGenerationModel",
    "PagedAttentionRuntimeState",
    "PerfHook",
    "PerfMojoGenerator",
    "SpeculativeContinuousBatchingGenerator",
    "SpeculativeDecoder",
    "TopKSampler",
    "dp_allreduce",
    "dp_gather",
    "dp_scatter",
    "merge_group_and_share_ffn",
    "round_up_bucket",
]
