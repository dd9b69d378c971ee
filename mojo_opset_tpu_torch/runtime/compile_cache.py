"""Compiled-step pool: decode steps captured once as CUDA graphs, then replayed.

Counterpart of the JAX package's ``runtime/compile_cache.py``
(``CompiledStepPool`` :22-66, ``round_up_bucket`` :69-76), whose docstring
names the reference's ``DeviceGraphPool`` (capture, replay, invalidation
when the session changes). JAX keeps one jitted executable per step
signature with the caches donated; here a signature keeps one
``torch.cuda.CUDAGraph``:

  * donated arguments (``donate_argnums``: the sessions' caches, which the
    step updates in place) are baked into the graph by address, so their
    storage is part of the key. A new session is a new key, and once a
    donated argument is freed its graphs are dropped (at the pool's next
    ``get_runner``);
  * every other tensor argument is copied, on each call, into a static
    buffer that the graph owns: nothing of the caller's is baked in;
  * ``static_argnums`` are hashable Python values, part of the key and
    passed as they are; a ``torch.Generator`` argument is keyed by identity
    (and held while its graph lives) and registered with the graph, so that
    each replay draws new numbers;
  * a key's first call runs the step eagerly on the capture stream (the
    warm-up: cuBLAS handles, the kernels' library build and lazily
    allocated buffers, such as kernel F's arrival counters, come into being
    outside any graph) and returns its result. Its second call captures the
    step into the memory pool that the pool's graphs share, then replays
    it; later calls replay. A key seen once captures nothing;
  * what a capture counted on the kernels' launch counters and the ops'
    ``golden_calls`` is taken back off and credited on every replay
    (``backends.cuda.kernels.recorded_counts``);
  * a capture that fails raises, naming the module it failed in; nothing
    runs eagerly in its place;
  * each call is spanned (``utils.tracing.span``): ``mojo.graph.lookup``
    (the signature and its runner), ``mojo.graph.warm_up``,
    ``mojo.graph.capture`` and ``mojo.graph.replay``, the last holding
    ``mojo.graph.inputs`` (the copies into the static buffers), the
    graph's launch and ``mojo.graph.outputs`` (the outputs' clone).

Graphs need the card: ``get_runner`` raises ``ValueError`` on a CPU tensor.
A sharded model's collectives are captured with its step: NCCL's can be
(each key's eager warm-up runs them on the capture stream first), gloo's
cannot, so asking for graphs of a model with a gloo group raises; nothing
turns graphs off in silence.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Dict, Hashable, Optional

import torch

from mojo_opset_tpu_torch.runtime import comm_context
from mojo_opset_tpu_torch.utils.logging import get_logger
from mojo_opset_tpu_torch.utils.tracing import span

logger = get_logger(__name__)


def _kernels():
    """The cuda tier's launch counters (imported on first use: the tier's ops import the runtime)."""
    from mojo_opset_tpu_torch.backends.cuda import kernels

    return kernels


def resolve_device_graph(device_graph: Optional[bool], model) -> bool:
    """Whether an entry point serving ``model`` replays from CUDA graphs: ``device_graph`` when the caller gives
    it (``True`` raises for a model off the card), else the model config's ``runtime_config.use_device_graph``
    (on when the model has no config) for a model on the card, and off elsewhere. Graphs of a model that
    communicates over a group a graph cannot capture (gloo) raise."""
    device = next(model.parameters()).device
    wanted = device_graph
    if device_graph is None:
        runtime = getattr(getattr(model, "config", None), "runtime_config", None)
        wanted = device.type == "cuda" and (runtime is None or runtime.use_device_graph)
    uncapturable = sorted({b for b in map(comm_context.capturable, comm_context.model_groups(model)) if b})
    if wanted and uncapturable:
        raise ValueError(f"a CUDA graph cannot capture the model's {'/'.join(uncapturable)} collectives: shard it "
                         "over NCCL groups on the card, or pass device_graph=False")
    if device_graph is None:
        return wanted
    if device_graph and device.type != "cuda":
        raise ValueError(f"device_graph=True needs a model on the card (CUDA graphs replay only there); this one is "
                         f"on {device}: pass device_graph=None or False")
    return bool(device_graph)


def _tensors(obj) -> list:
    """The tensors of ``obj``: a tensor, a list or tuple of them, or an object holding them in its attributes
    (``KVCaches``)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for item in obj for t in _tensors(item)]
    if hasattr(obj, "__dict__"):
        return [t for item in vars(obj).values() for t in _tensors(item)]
    return []


def _map(fn, obj):
    """``obj`` (a tensor, None or a tuple/list of them) with ``fn`` applied to every tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(fn, item) for item in obj)
    if obj is None:
        return None
    raise TypeError(f"a step's inputs and outputs are tensors, None or tuples of them, got {type(obj).__name__}")


class _ModulePath:
    """The modules being run while it is active: on an exception, the innermost is the op that raised."""

    def __init__(self):
        self.stack = []

    def __enter__(self):
        def push(module, args):
            self.stack.append(type(module).__name__)

        def pop(module, args, out):  # returns None: a forward hook's value would replace the module's output
            self.stack.pop()

        self.handles = (torch.nn.modules.module.register_module_forward_pre_hook(push),
                        torch.nn.modules.module.register_module_forward_hook(pop))
        return self

    def __exit__(self, *exc):
        for handle in self.handles:
            handle.remove()
        return False

    def __str__(self):
        return " > ".join(self.stack) or "the step function outside any module"


class StepRunner:
    """One signature's graph: its static input buffers, its outputs and what its capture counted."""

    def __init__(self, pool: "CompiledStepPool", args: tuple, device: torch.device):
        self.pool = pool
        self.device = device
        self.static = [None if i in pool._static or i in pool._donate or isinstance(a, torch.Generator)
                       else _map(lambda t: torch.empty_like(t, device=device), a) for i, a in enumerate(args)]
        # a generator is keyed by identity: held here, its id names no other generator while the graph lives
        self.generators = [a for a in args if isinstance(a, torch.Generator)]
        self.calls = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.credit: dict = {}
        self.capture_ms: Optional[float] = None

    def _inputs(self, args: tuple) -> tuple:
        """``args`` with every copied input replaced by its static buffer, after the copy."""
        def copy(dst, src):
            dst.copy_(src, non_blocking=True)
            return dst

        out = []
        for a, buf in zip(args, self.static):
            if buf is None:
                out.append(a)
            elif isinstance(buf, torch.Tensor):
                out.append(copy(buf, a))
            else:
                out.append(type(buf)(None if b is None else copy(b, x) for b, x in zip(buf, a)))
        return tuple(out)

    def __call__(self, *args):
        with torch.inference_mode():
            if self.calls == 0:
                with span("mojo.graph.warm_up"):
                    self.calls = 1
                    return self._warm_up(self._inputs(args))
            if self.graph is None:
                with span("mojo.graph.capture"):
                    self._capture(self._inputs(args))
                return self._replay(None)
            return self._replay(args)

    def _replay(self, args):
        """Copy ``args`` into the static buffers (None: they hold this call's inputs already), replay, and
        return a clone of the outputs."""
        with span("mojo.graph.replay"):
            if args is not None:
                with span("mojo.graph.inputs"):
                    self._inputs(args)
            self.graph.replay()
            _kernels().credit_counts(self.credit)
            self.calls += 1
            with span("mojo.graph.outputs"):
                return _map(torch.Tensor.clone, self.out)

    def _warm_up(self, inputs):
        current, side = torch.cuda.current_stream(self.device), self.pool.stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.pool._step_fn(*inputs)
        current.wait_stream(side)
        _map(lambda t: t.record_stream(current), out)
        return out

    def _capture(self, inputs) -> None:
        graph = torch.cuda.CUDAGraph()
        for a in inputs:
            if isinstance(a, torch.Generator) and a.device.type == "cuda":
                if not hasattr(graph, "register_generator_state"):
                    raise RuntimeError(
                        "this PyTorch cannot register a torch.Generator with a CUDA graph "
                        "(torch.cuda.CUDAGraph.register_generator_state): a sampled step cannot replay; serve it "
                        "with device_graph=False")
                graph.register_generator_state(a)
        t0 = time.perf_counter()
        path = _ModulePath()
        collecting = gc.isenabled()
        gc.disable()  # a collection inside the capture could free a dead pool's graph, which ends the capture
        try:
            with _kernels().recorded_counts() as record, path:
                with torch.cuda.graph(graph, pool=self.pool.mempool(), stream=self.pool.stream(self.device)):
                    out = self.pool._step_fn(*inputs)
        except Exception as err:
            cause = f" (after: {err.__context__})" if err.__context__ is not None else ""
            raise RuntimeError(f"CUDA graph capture of {self.pool.name} failed in {path}: {err}{cause}") from err
        finally:
            if collecting:
                gc.enable()
        self.capture_ms = (time.perf_counter() - t0) * 1e3  # host time: a capture runs nothing on the card
        self.graph, self.out, self.credit = graph, out, record
        logger.debug("CompiledStepPool %s: captured in %.1f ms", self.pool.name, self.capture_ms)


class CompiledStepPool:
    """Cache of captured step graphs keyed by the step's signature.

    ``step_fn(*args)`` must run on the card without reading a device value
    back to the host (a capture cannot), and return a tensor, None or a
    tuple of them. ``get_runner(*args)`` gives the signature's runner, which
    is called with arguments of the same signature."""

    def __init__(self, step_fn: Callable, donate_argnums=(0,), static_argnums=(), name: str = "step"):
        self._step_fn = step_fn
        self._donate = tuple(donate_argnums)
        self._static = tuple(static_argnums)
        self.name = name
        self._pool: Dict[Hashable, StepRunner] = {}
        self._dead: list = []
        self._mempool = None
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def mempool(self):
        """The memory pool that every graph of this pool captures into."""
        if self._mempool is None:
            self._mempool = torch.cuda.graph_pool_handle()
        return self._mempool

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        """The side stream on which this pool's steps warm up and are captured."""
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def signature(self, *args) -> Hashable:
        sig = []
        for i, a in enumerate(args):
            if i in self._static:
                sig.append(("static", a))
            elif i in self._donate:
                sig.append(("donated", tuple((tuple(t.shape), t.dtype, t.device, t.data_ptr()) for t in _tensors(a))))
            elif isinstance(a, torch.Generator):
                sig.append(("generator", id(a)))
            else:
                sig.append(tuple((tuple(t.shape), t.dtype) for t in _tensors(a)))
        return tuple(sig)

    def get_runner(self, *args) -> StepRunner:
        with span("mojo.graph.lookup"):
            for key in self._dead:
                self._pool.pop(key, None)
            self._dead.clear()
            key = self.signature(*args)
            runner = self._pool.get(key)
            if runner is None:
                runner = self._pool[key] = StepRunner(self, args, self._device(args))
                pool = weakref.ref(self)
                for i in self._donate:  # the key's graph goes with the first of its donated state to be freed
                    anchor = args[i] if hasattr(args[i], "__weakref__") or isinstance(args[i], torch.Tensor) else (
                        _tensors(args[i])[0])
                    weakref.finalize(anchor, _forget, pool, key)
            return runner

    def _device(self, args) -> torch.device:
        """The card the step runs on: its donated state's (every donated tensor on the card), else its inputs'."""
        donated = [t for i in self._donate if i < len(args) for t in _tensors(args[i])]
        tensors = donated or [t for i, a in enumerate(args) if i not in self._static for t in _tensors(a)]
        cuda = [t.device for t in tensors if t.is_cuda]
        if not cuda or len(cuda) < len(donated):
            raise ValueError(f"CompiledStepPool {self.name}: CUDA graphs need the card, and the step's state is on "
                             f"{tensors[0].device if tensors else 'no device'}")
        return cuda[0]

    def runners(self) -> list:
        return list(self._pool.values())

    def memory_bytes(self) -> int:
        """Bytes of the card's memory that the pool's captures hold (the segments of its memory pool)."""
        if self._mempool is None:
            return 0
        handle = tuple(self._mempool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == handle)


def _forget(pool_ref, key) -> None:
    pool = pool_ref()
    if pool is not None:
        pool._dead.append(key)


BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def round_up_bucket(n: int, buckets=BUCKETS) -> int:
    """Pad a dynamic token count to a fixed bucket, so that the steps of a
    batch take few signatures (the JAX package recompiles once a bucket)."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]
