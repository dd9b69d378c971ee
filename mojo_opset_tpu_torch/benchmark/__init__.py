"""Timing protocols of the port (counterpart of the JAX package's
``benchmark/``): so far the Wan DiT's denoise step."""
