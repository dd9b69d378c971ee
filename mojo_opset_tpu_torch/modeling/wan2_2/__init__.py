from mojo_opset_tpu_torch.modeling.wan2_2.modeling_t5 import (
    T5CrossAttention,
    T5Decoder,
    T5Encoder,
    T5EncoderModel,
    T5Model,
    T5SelfAttention,
    umt5_xxl_encoder,
)
from mojo_opset_tpu_torch.modeling.wan2_2.modeling_vae import (
    Wan2_2_VAE,
    WanVAE_,
)
from mojo_opset_tpu_torch.modeling.wan2_2.modeling_wan import (
    Head,
    WanAttentionBlock,
    WanConfig,
    WanCrossAttention,
    WanModel,
    WanSelfAttention,
    rope_params,
    sinusoidal_embedding_1d,
)

__all__ = [
    "Head",
    "T5CrossAttention",
    "T5Decoder",
    "T5Encoder",
    "T5EncoderModel",
    "T5Model",
    "T5SelfAttention",
    "Wan2_2_VAE",
    "WanAttentionBlock",
    "WanConfig",
    "WanCrossAttention",
    "WanModel",
    "WanSelfAttention",
    "WanVAE_",
    "rope_params",
    "sinusoidal_embedding_1d",
    "umt5_xxl_encoder",
]
