"""mojo_opset_tpu_torch — the PyTorch + CUDA port of the JAX
package beside it.

The ``Mojo*`` op contracts with a plain PyTorch golden tier (``ref``) and
hand-written Hopper kernels (``cuda``), the ``Mojo*Function`` training ops
(attention, masked diffusion attention, RMSNorm, SiLU, RoPE, the causal
conv1d and the fused linear + CE loss, each with kernel backwards), the
paged-KV serving runtime, and the models (Qwen3 dense with its int8 serving modes and its training
forward, Qwen3-MoE, DeepSeek-V3, Seed-OSS in bf16 and w8a8, the Wan2.2 DiT),
the tooling (``utils/debugger.py``, ``utils/profiler.py``,
``utils/tracing.py``, the native block allocator in ``runtime/native/``)
and the example entry points (``mojo_opset_tpu_torch.examples``).
``MOJO_BACKEND`` in {ref, cuda} picks a tier when an op is constructed; the
default is ``cuda``, whose kernel wrappers run their plain versions on CPU
tensors.

Import order matters for dispatch: core classes create per-op registries;
importing the backend package afterwards registers the cuda tier, then
third-party tiers load from the ``mojo_opset_tpu_torch.plugins`` entry-point
group (``MOJO_OPSET_PLUGIN_AUTOLOAD=0`` skips them). ``MOJO_DEBUG=1``
enables the precision debugger (``utils/debugger.py``) at import.
"""

from __future__ import annotations

import os

__version__ = "0.1.0"

from mojo_opset_tpu_torch.core import BackendNotAvailable, MojoBackendRegistry, MojoFunction, MojoOperator  # noqa: F401
from mojo_opset_tpu_torch.core.operators import *  # noqa: F401,F403
from mojo_opset_tpu_torch.core.functions import *  # noqa: F401,F403
from mojo_opset_tpu_torch.experimental.operators import *  # noqa: F401,F403,E402
from mojo_opset_tpu_torch.experimental.functions import *  # noqa: F401,F403,E402

import mojo_opset_tpu_torch.backends.cuda  # noqa: F401,E402

if os.environ.get("MOJO_DEBUG", "0") == "1":
    from mojo_opset_tpu_torch.utils.debugger import MojoDebugger

    MojoDebugger.enable()


def _autoload_plugins() -> None:
    """Load third-party backends from the ``mojo_opset_tpu_torch.plugins``
    entry points; a plugin that fails to load is logged and skipped."""
    if os.environ.get("MOJO_OPSET_PLUGIN_AUTOLOAD", "1") != "1":
        return
    from importlib.metadata import entry_points

    for ep in entry_points(group="mojo_opset_tpu_torch.plugins"):
        try:
            ep.load()
        except Exception as exc:
            from mojo_opset_tpu_torch.utils.logging import get_logger

            get_logger(__name__).warning("Failed to load plugin %s: %s", ep.name, exc)


_autoload_plugins()
