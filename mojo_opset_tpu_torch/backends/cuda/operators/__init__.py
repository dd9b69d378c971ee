from mojo_opset_tpu_torch.backends.cuda.operators.attention import CudaPagedDecodeGQA, CudaPagedPrefillGQA
from mojo_opset_tpu_torch.backends.cuda.operators.normalization import CudaRMSNorm
from mojo_opset_tpu_torch.backends.cuda.operators.position_embedding import CudaApplyRoPE

__all__ = ["CudaApplyRoPE", "CudaPagedDecodeGQA", "CudaPagedPrefillGQA", "CudaRMSNorm"]
