from mojo_opset_tpu_torch.modeling.seed_oss.modeling_seed_oss import (
    SeedOssAttention,
    SeedOssConfig,
    SeedOssDecoderLayer,
    SeedOssForCausalLM,
    SeedOssMLP,
)
from mojo_opset_tpu_torch.modeling.seed_oss.quantize import quantize_seed_oss

__all__ = [
    "SeedOssAttention",
    "SeedOssConfig",
    "SeedOssDecoderLayer",
    "SeedOssForCausalLM",
    "SeedOssMLP",
    "quantize_seed_oss",
]
