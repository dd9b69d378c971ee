from mojo_opset_tpu_torch.experimental.operators.kv_cache import (
    MojoDequantFromPagedKVCache,
    MojoStorePagedKVCacheC8,
)
from mojo_opset_tpu_torch.experimental.operators.kv_quant_attention import (
    MojoPagedDecodeGQAWithKVDequant,
    MojoPagedPrefillGQAWithKVDequant,
    dynamic_quantize,
)

__all__ = [
    "MojoDequantFromPagedKVCache",
    "MojoPagedDecodeGQAWithKVDequant",
    "MojoPagedPrefillGQAWithKVDequant",
    "MojoStorePagedKVCacheC8",
    "dynamic_quantize",
]
