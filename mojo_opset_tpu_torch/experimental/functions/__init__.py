from mojo_opset_tpu_torch.experimental.functions.diffusion_attention import (
    MojoDiffusionAttentionFunction,
    block_diffusion_mask,
    mojo_diffusion_attention,
)

__all__ = ["MojoDiffusionAttentionFunction", "block_diffusion_mask", "mojo_diffusion_attention"]
