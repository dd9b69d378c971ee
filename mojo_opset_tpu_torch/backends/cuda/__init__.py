"""The ``cuda`` tier: hand-written Hopper kernels (``csrc/``) behind
``Cuda<Op>`` classes. Importing this package registers the tier."""

import mojo_opset_tpu_torch.backends.cuda.operators  # noqa: F401
