"""Tensor, expert and data parallelism over ``torch.distributed`` (NCCL on
the card, gloo on the CPU): process groups (``mesh``), styles that shard a
module in place and place its collectives (``styles``), JAX's sharding
rules (``plans``) and per-rank checkpoints (``checkpoint``)."""

from mojo_opset_tpu_torch.parallel.checkpoint import (
    mojo_parallel_load_state_dict_naive,
    mojo_parallel_save_state_dict_naive,
    stat_dict_rename_hook,
    state_dict,
)
from mojo_opset_tpu_torch.parallel.mesh import (
    MojoMesh,
    build_mesh,
    init_distributed,
    local_mesh_for_role,
    mesh_from_parallel_config,
)
from mojo_opset_tpu_torch.parallel.plans import ShardRule, moe_ep_rules, qwen3_tp_rules, shard_model
from mojo_opset_tpu_torch.parallel.styles import (
    MojoColwiseParallel,
    MojoDataParallel,
    MojoDistributedModule,
    MojoExpertParallel,
    MojoParallelStyle,
    MojoQKVColwiseParallel,
    MojoRegisterableParallelStyle,
    MojoRowwiseParallel,
    MojoSwiGLUParallel,
    MojoTensorParallel,
    head_plan,
    mojo_parallelize_module,
)

__all__ = [
    "MojoColwiseParallel",
    "MojoDataParallel",
    "MojoDistributedModule",
    "MojoExpertParallel",
    "MojoMesh",
    "MojoParallelStyle",
    "MojoQKVColwiseParallel",
    "MojoRegisterableParallelStyle",
    "MojoRowwiseParallel",
    "MojoSwiGLUParallel",
    "MojoTensorParallel",
    "ShardRule",
    "build_mesh",
    "head_plan",
    "init_distributed",
    "local_mesh_for_role",
    "mesh_from_parallel_config",
    "moe_ep_rules",
    "mojo_parallel_load_state_dict_naive",
    "mojo_parallel_save_state_dict_naive",
    "mojo_parallelize_module",
    "qwen3_tp_rules",
    "shard_model",
    "stat_dict_rename_hook",
    "state_dict",
]
