"""Per-op perf descriptors of the port: one module for each of the JAX
package's ``tests/perf_new/{operators,functions}/*.py``, with the same spec
names, cases (ids, tags, params) and workloads (inputs, op kwargs, state,
args, kwargs, flops, bytes, threaded outputs). ``run_perf`` and ``launch``
discover them (``api.discover_perf_specs``); ``profile(kernels=...)``
names the port's kernels where JAX names its Pallas or XLA kernels."""
