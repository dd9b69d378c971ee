"""Experimental ops and functions (counterpart of the JAX package's
``experimental/``): the int8 (C8) KV cache and the attention that reads it,
the MLA ops, the Wan DiT's grid RoPE, the T5 relative position bias, the Wan
VAE's channel norm, and the diffusion-attention Function."""
