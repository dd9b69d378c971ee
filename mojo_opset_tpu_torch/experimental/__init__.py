"""Experimental ops (counterpart of the JAX package's ``experimental/``):
so far the int8 (C8) KV cache and the attention that reads it."""
