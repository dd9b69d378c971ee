"""mojo_opset_tpu_torch — the PyTorch + CUDA port of the JAX
package beside it.

The ``Mojo*`` op contracts with a plain PyTorch golden tier (``ref``) and
hand-written Hopper kernels (``cuda``), the ``Mojo*Function`` training ops
(attention, masked diffusion attention, RMSNorm, SiLU, RoPE, the causal
conv1d and the fused linear + CE loss, each with kernel backwards), the
paged-KV serving runtime, and the models (Qwen3 dense with its int8 serving modes and its training
forward, Qwen3-MoE, DeepSeek-V3, Seed-OSS in bf16 and w8a8, the Wan2.2 DiT).
``MOJO_BACKEND`` in {ref, cuda} picks a tier when an op is constructed; the
default is ``cuda``, whose kernel wrappers run their plain versions on CPU
tensors.

Import order matters for dispatch: core classes create per-op registries;
importing the backend package afterwards registers the cuda tier.
"""

from __future__ import annotations

__version__ = "0.1.0"

from mojo_opset_tpu_torch.core import BackendNotAvailable, MojoBackendRegistry, MojoFunction, MojoOperator  # noqa: F401
from mojo_opset_tpu_torch.core.operators import *  # noqa: F401,F403
from mojo_opset_tpu_torch.core.functions import *  # noqa: F401,F403
from mojo_opset_tpu_torch.experimental.operators import *  # noqa: F401,F403,E402
from mojo_opset_tpu_torch.experimental.functions import *  # noqa: F401,F403,E402

import mojo_opset_tpu_torch.backends.cuda  # noqa: F401,E402
