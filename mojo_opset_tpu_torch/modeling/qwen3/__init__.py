from mojo_opset_tpu_torch.modeling.qwen3.modeling_qwen3 import (
    Qwen3Attention,
    Qwen3Config,
    Qwen3DecoderLayer,
    Qwen3ForCausalLM,
    Qwen3MLP,
    Qwen3Model,
)
from mojo_opset_tpu_torch.modeling.qwen3.modeling_qwen3_moe import (
    Qwen3MoeConfig,
    Qwen3MoeDecoderLayer,
    Qwen3MoeForCausalLM,
)
from mojo_opset_tpu_torch.modeling.qwen3.quantize import quantize_linear_weight, quantize_qwen3

__all__ = [
    "Qwen3Attention",
    "Qwen3Config",
    "Qwen3DecoderLayer",
    "Qwen3ForCausalLM",
    "Qwen3MLP",
    "Qwen3Model",
    "Qwen3MoeConfig",
    "Qwen3MoeDecoderLayer",
    "Qwen3MoeForCausalLM",
    "quantize_linear_weight",
    "quantize_qwen3",
]
