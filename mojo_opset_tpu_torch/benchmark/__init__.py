"""Timing protocols and the per-op perf harness of the port (counterpart of
the JAX package's ``benchmark/``): ``timing`` (chained device timing, the
profiler's kernel spans), ``api`` (the ``@mojo_perf`` spec API),
``run_perf`` and ``launch`` (the CLIs), the descriptors in ``specs``, the
Wan DiT's ``dit_protocol``, and the kernel tools (``kernel_ab``,
``split_sweep``, ``kernel_resources``, ``conv1d_window_ab``)."""
