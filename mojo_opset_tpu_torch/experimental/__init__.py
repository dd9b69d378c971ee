"""Experimental ops and functions (counterpart of the JAX package's
``experimental/``): the int8 (C8) KV cache and the attention that reads it,
the MLA ops, the Wan DiT's grid RoPE, and the diffusion-attention Function."""
