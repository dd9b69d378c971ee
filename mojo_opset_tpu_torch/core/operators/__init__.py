from mojo_opset_tpu_torch.core.operators.activation import MojoGelu, MojoSilu
from mojo_opset_tpu_torch.core.operators.attention import (
    MojoDecodeGQA,
    MojoPagedDecodeGQA,
    MojoPagedDecodeSWA,
    MojoPagedPrefillGQA,
    MojoPrefillGQA,
    MojoSdpa,
    MojoSWA,
    assert_paged_decode_contract,
    assert_paged_prefill_contract,
    expand_gqa,
    seq_lens_from_cu,
    window_mask_rows,
)
from mojo_opset_tpu_torch.core.operators.embedding import MojoEmbedding
from mojo_opset_tpu_torch.core.operators.gemm import MojoGemm, MojoGroupGemm, MojoQuantGemm
from mojo_opset_tpu_torch.core.operators.kv_cache import (
    MojoStorePagedKVCache,
    build_paged_kv_token_indices,
    store_paged_rows,
)
from mojo_opset_tpu_torch.core.operators.moe import (
    MojoExperts,
    MojoMoE,
    MojoMoECombine,
    MojoMoEDispatch,
    MojoMoEGating,
    count_expert_tokens,
)
from mojo_opset_tpu_torch.core.operators.normalization import MojoLayerNorm, MojoRMSNorm, MojoRMSNormQuant
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
    "MojoDecodeGQA",
    "MojoDequant",
    "MojoDynamicQuant",
    "MojoEmbedding",
    "MojoExperts",
    "MojoGelu",
    "MojoGemm",
    "MojoGroupGemm",
    "MojoJoinProbRejectSampling",
    "MojoLayerNorm",
    "MojoMoE",
    "MojoMoECombine",
    "MojoMoEDispatch",
    "MojoMoEGating",
    "MojoPagedDecodeGQA",
    "MojoPagedDecodeSWA",
    "MojoPagedPrefillGQA",
    "MojoPrefillGQA",
    "MojoQuantGemm",
    "MojoRejectSampling",
    "MojoRMSNorm",
    "MojoRMSNormQuant",
    "MojoRotaryEmbedding",
    "MojoSdpa",
    "MojoSilu",
    "MojoStaticQuant",
    "MojoStorePagedKVCache",
    "MojoSWA",
    "MojoTopKSampling",
    "MojoTopPFilter",
    "MojoTopPSampling",
    "assert_paged_decode_contract",
    "assert_paged_prefill_contract",
    "build_paged_kv_token_indices",
    "count_expert_tokens",
    "expand_gqa",
    "seq_lens_from_cu",
    "store_paged_rows",
    "window_mask_rows",
]
