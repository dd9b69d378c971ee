"""The ``cuda`` tier: hand-written Hopper kernels (``csrc/``) behind
``Cuda<Op>`` and ``Cuda<Op>Function`` classes. Importing this package
registers the tier."""

import mojo_opset_tpu_torch.backends.cuda.functions  # noqa: F401
import mojo_opset_tpu_torch.backends.cuda.operators  # noqa: F401
