from mojo_opset_tpu_torch.modeling.deepseekv3.modeling_deepseek_v3 import (
    DeepseekV3Attention,
    DeepseekV3Config,
    DeepseekV3DecoderLayer,
    DeepseekV3ForCausalLM,
    DeepseekV3MLP,
    DeepseekV3Model,
    DeepseekV3MoE,
    MLARuntimeState,
)
from mojo_opset_tpu_torch.modeling.deepseekv3.quantize import (
    deepseek_v3_twin,
    quantize_deepseek_v3,
    quantize_deepseek_v3_layer,
)

__all__ = [
    "DeepseekV3Attention",
    "DeepseekV3Config",
    "DeepseekV3DecoderLayer",
    "DeepseekV3ForCausalLM",
    "DeepseekV3MLP",
    "DeepseekV3Model",
    "DeepseekV3MoE",
    "MLARuntimeState",
    "deepseek_v3_twin",
    "quantize_deepseek_v3",
    "quantize_deepseek_v3_layer",
]
