from mojo_opset_tpu_torch.core.operators.activation import MojoSilu
from mojo_opset_tpu_torch.core.operators.attention import (
    MojoPagedDecodeGQA,
    MojoPagedPrefillGQA,
    expand_gqa,
    seq_lens_from_cu,
)
from mojo_opset_tpu_torch.core.operators.embedding import MojoEmbedding
from mojo_opset_tpu_torch.core.operators.gemm import MojoGemm, MojoQuantGemm
from mojo_opset_tpu_torch.core.operators.kv_cache import (
    MojoStorePagedKVCache,
    build_paged_kv_token_indices,
)
from mojo_opset_tpu_torch.core.operators.normalization import MojoRMSNorm, MojoRMSNormQuant
from mojo_opset_tpu_torch.core.operators.position_embedding import (
    MojoApplyRoPE,
    MojoRotaryEmbedding,
)
from mojo_opset_tpu_torch.core.operators.quantize import MojoDequant, MojoDynamicQuant, MojoStaticQuant
from mojo_opset_tpu_torch.core.operators.sampling import (
    MojoApplyPenaltiesTempurate,
    MojoJoinProbRejectSampling,
    MojoRejectSampling,
    MojoTopKSampling,
    MojoTopPFilter,
    MojoTopPSampling,
)

__all__ = [
    "MojoApplyPenaltiesTempurate",
    "MojoApplyRoPE",
    "MojoDequant",
    "MojoDynamicQuant",
    "MojoEmbedding",
    "MojoGemm",
    "MojoJoinProbRejectSampling",
    "MojoPagedDecodeGQA",
    "MojoPagedPrefillGQA",
    "MojoQuantGemm",
    "MojoRejectSampling",
    "MojoRMSNorm",
    "MojoRMSNormQuant",
    "MojoRotaryEmbedding",
    "MojoSilu",
    "MojoStaticQuant",
    "MojoStorePagedKVCache",
    "MojoTopKSampling",
    "MojoTopPFilter",
    "MojoTopPSampling",
    "build_paged_kv_token_indices",
    "expand_gqa",
    "seq_lens_from_cu",
]
