from mojo_opset_tpu_torch.backends.cuda.operators.attention import (
    CudaPagedDecodeGQA,
    CudaPagedDecodeGQAWithKVDequant,
    CudaPagedDecodeSWA,
    CudaPagedDecodeSWAWithKVDequant,
    CudaPagedPrefillGQA,
    CudaPagedPrefillGQAWithKVDequant,
    CudaPrefillGQA,
    CudaSdpa,
    CudaSWA,
)
from mojo_opset_tpu_torch.backends.cuda.operators.compute_with_comm import CudaAllGatherGemm, CudaGemmReduceScatter
from mojo_opset_tpu_torch.backends.cuda.operators.gemm import CudaGroupGemm, CudaQuantGemm
from mojo_opset_tpu_torch.backends.cuda.operators.mla import CudaPagedDecodeMLA, CudaPagedPrefillMLA
from mojo_opset_tpu_torch.backends.cuda.operators.moe import CudaExperts, CudaMoE, CudaQuantExperts, CudaQuantMoE
from mojo_opset_tpu_torch.backends.cuda.operators.normalization import (
    CudaResidualAddRMSNorm,
    CudaRMSNorm,
    CudaRMSNormQuant,
)
from mojo_opset_tpu_torch.backends.cuda.operators.position_embedding import CudaApplyRoPE

__all__ = [
    "CudaAllGatherGemm",
    "CudaApplyRoPE",
    "CudaExperts",
    "CudaGemmReduceScatter",
    "CudaGroupGemm",
    "CudaMoE",
    "CudaPagedDecodeGQA",
    "CudaPagedDecodeGQAWithKVDequant",
    "CudaPagedDecodeMLA",
    "CudaPagedDecodeSWA",
    "CudaPagedDecodeSWAWithKVDequant",
    "CudaPagedPrefillGQA",
    "CudaPagedPrefillGQAWithKVDequant",
    "CudaPagedPrefillMLA",
    "CudaPrefillGQA",
    "CudaQuantExperts",
    "CudaQuantGemm",
    "CudaQuantMoE",
    "CudaResidualAddRMSNorm",
    "CudaRMSNorm",
    "CudaRMSNormQuant",
    "CudaSdpa",
    "CudaSWA",
]
