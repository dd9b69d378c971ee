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
from mojo_opset_tpu_torch.experimental.operators.mla import (
    MojoDecodeMLA,
    MojoPagedDecodeMLA,
    MojoPagedPrefillMLA,
    MojoPrefillMLA,
)

__all__ = [
    "MojoDecodeMLA",
    "MojoDequantFromPagedKVCache",
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
