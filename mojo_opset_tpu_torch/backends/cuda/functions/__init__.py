from mojo_opset_tpu_torch.backends.cuda.functions.attention import CudaSWAFunction, FlashSWA, flash_attention

__all__ = ["CudaSWAFunction", "FlashSWA", "flash_attention"]
