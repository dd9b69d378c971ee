from mojo_opset_tpu_torch.experimental.operators.activation import MojoRotateActivation
from mojo_opset_tpu_torch.experimental.operators.attention_gate import MojoFusedAttnOutputGate
from mojo_opset_tpu_torch.experimental.operators.gemm import MojoQuantBatchGemmReduceSum
from mojo_opset_tpu_torch.experimental.operators.indexer import MojoIndexer, MojoLightningIndexer
from mojo_opset_tpu_torch.experimental.operators.kv_cache import (
    MojoDequantFromPagedKVCache,
    MojoStoreLowrank,
    MojoStorePagedKVCacheC8,
    MojoStorePagedMLAKVCache,
)
from mojo_opset_tpu_torch.experimental.operators.kv_quant_attention import (
    MojoPagedDecodeGQAWithKVDequant,
    MojoPagedDecodeNstepSWA,
    MojoPagedDecodeSWAWithKVDequant,
    MojoPagedPrefillGQAWithKVDequant,
    MojoPagedPrefillSWAWithKVDequant,
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
from mojo_opset_tpu_torch.experimental.operators.normalization import (
    MojoChannelRMSNorm,
    MojoGroupLayerNorm,
    MojoGroupRMSNormInplace,
    MojoRMSNormInplace,
)
from mojo_opset_tpu_torch.experimental.operators.nsa import (
    MojoDecodeNSA,
    MojoPagedDecodeNSA,
    MojoPagedPrefillNSA,
    MojoPrefillNSA,
)
from mojo_opset_tpu_torch.experimental.operators.position_embedding import (
    MojoGridRoPE,
    MojoMRoPEInplace,
    MojoRelativeEmbedding,
)
from mojo_opset_tpu_torch.experimental.operators.sage import MojoPagedPrefillSageGQA

__all__ = [
    "MojoChannelRMSNorm",
    "MojoDecodeMLA",
    "MojoDecodeNSA",
    "MojoDequantFromPagedKVCache",
    "MojoFusedAttnOutputGate",
    "MojoFusedSwiGLUMoEScaleDynamicQuantize",
    "MojoGridRoPE",
    "MojoGroupLayerNorm",
    "MojoGroupRMSNormInplace",
    "MojoIndexer",
    "MojoLightningIndexer",
    "MojoMoEInitRoutingDynamicQuant",
    "MojoMRoPEInplace",
    "MojoPagedDecodeGQAWithKVDequant",
    "MojoPagedDecodeMLA",
    "MojoPagedDecodeNSA",
    "MojoPagedDecodeNstepSWA",
    "MojoPagedDecodeSWAWithKVDequant",
    "MojoPagedPrefillGQAWithKVDequant",
    "MojoPagedPrefillMLA",
    "MojoPagedPrefillNSA",
    "MojoPagedPrefillSageGQA",
    "MojoPagedPrefillSWAWithKVDequant",
    "MojoPrefillMLA",
    "MojoPrefillNSA",
    "MojoQuantBatchGemmReduceSum",
    "MojoRelativeEmbedding",
    "MojoRMSNormInplace",
    "MojoRotateActivation",
    "MojoStoreLowrank",
    "MojoStorePagedKVCacheC8",
    "MojoStorePagedMLAKVCache",
    "dynamic_quantize",
]
