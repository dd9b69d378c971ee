from mojo_opset_tpu_torch.experimental.operators.kv_cache import (
    MojoDequantFromPagedKVCache,
    MojoStorePagedKVCacheC8,
    MojoStorePagedMLAKVCache,
)
from mojo_opset_tpu_torch.experimental.operators.kv_quant_attention import (
    MojoPagedDecodeGQAWithKVDequant,
    MojoPagedDecodeSWAWithKVDequant,
    MojoPagedPrefillGQAWithKVDequant,
    dynamic_quantize,
)
from mojo_opset_tpu_torch.experimental.operators.moe import (
    MojoFusedSwiGLUMoEScaleDynamicQuantize,
    MojoMoEInitRoutingDynamicQuant,
)
from mojo_opset_tpu_torch.experimental.operators.mla import (
    MojoDecodeMLA,
    MojoPagedDecodeMLA,
    MojoPagedPrefillMLA,
    MojoPrefillMLA,
)
from mojo_opset_tpu_torch.experimental.operators.position_embedding import MojoGridRoPE

__all__ = [
    "MojoDecodeMLA",
    "MojoDequantFromPagedKVCache",
    "MojoFusedSwiGLUMoEScaleDynamicQuantize",
    "MojoGridRoPE",
    "MojoMoEInitRoutingDynamicQuant",
    "MojoPagedDecodeGQAWithKVDequant",
    "MojoPagedDecodeMLA",
    "MojoPagedDecodeSWAWithKVDequant",
    "MojoPagedPrefillGQAWithKVDequant",
    "MojoPagedPrefillMLA",
    "MojoPrefillMLA",
    "MojoStorePagedKVCacheC8",
    "MojoStorePagedMLAKVCache",
    "dynamic_quantize",
]
