"""Experimental ops and functions (counterpart of the JAX package's
``experimental/``): the int8 (C8) KV cache and the attention that reads it,
the windowed n-step decode, the MLA ops, NSA, Sage, DeepSeek-V3.2's
indexer, the Hadamard rotation, the gated attention output, the group and
"in place" norms, the Wan DiT's grid RoPE, the T5 relative position bias,
the Wan VAE's channel norm, and the diffusion-attention Function."""

from mojo_opset_tpu_torch.experimental.operators import *  # noqa: F401,F403
