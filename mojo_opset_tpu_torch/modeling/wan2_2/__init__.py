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
    "WanAttentionBlock",
    "WanConfig",
    "WanCrossAttention",
    "WanModel",
    "WanSelfAttention",
    "rope_params",
    "sinusoidal_embedding_1d",
]
