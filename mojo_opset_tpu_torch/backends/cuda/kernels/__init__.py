"""Kernel wrappers: each module holds one kernel's launcher, its plain
PyTorch version and its ``launches`` counter; kernels J (``flash_swa``) and
O (``flash_diffusion``) have three entry points, kernel N (``flce``) four,
kernels L (``silu_vjp``) and Q (``conv1d_vjp``) two, each with its own
counter, and ``norms`` holds kernels A and P, each with its own; kernel G
(``int4_matmul``) also counts its launches by route and M, kernel R
(``group_quant_gemm``) by route.

A CUDA graph replays its kernels without calling the wrappers, so the
counters would miss them: ``recorded_counts`` takes what a capture counted
back off every counter (a capture launches nothing) and keeps it, and
``credit_counts`` adds it once for each replay (``runtime/compile_cache.py``).
The same holds for the ``golden_calls`` of the cuda-tier op and Function
classes."""

import contextlib
import importlib
import inspect
import pkgutil

from mojo_opset_tpu_torch.backends.cuda.kernels import (
    conv1d_vjp,
    flash_diffusion,
    flash_swa,
    flce,
    group_gemm,
    group_quant_gemm,
    int4_matmul,
    int8_matmul,
    mla_decode,
    norms,
    paged_decode,
    paged_prefill,
    rmsnorm_quant,
    rmsnorm_vjp,
    rope,
    rope_head_first,
    silu_vjp,
)

ALL = (norms, rope, paged_decode, paged_prefill, rmsnorm_quant, int8_matmul, int4_matmul, group_gemm, mla_decode,
       rmsnorm_vjp, rope_head_first, group_quant_gemm)

# (name, module, counter attribute) of every entry point
COUNTERS = [(module.__name__.rsplit(".", 1)[-1], module, "launches") for module in ALL] + [
    ("flash_swa_fwd", flash_swa, "launches"), ("flash_swa_dq", flash_swa, "launches_dq"),
    ("flash_swa_dkv", flash_swa, "launches_dkv"), ("silu_fwd", silu_vjp, "launches"),
    ("silu_bwd", silu_vjp, "launches_bwd"), ("flce_stats", flce, "launches"), ("flce_dz", flce, "launches_dz"),
    ("flce_dx", flce, "launches_dx"), ("flce_dw", flce, "launches_dw"),
    ("flash_diffusion_fwd", flash_diffusion, "launches"), ("flash_diffusion_dq", flash_diffusion, "launches_dq"),
    ("flash_diffusion_dkv", flash_diffusion, "launches_dkv"), ("residual_add_rmsnorm", norms, "launches_residual_add"),
    ("conv1d_fwd", conv1d_vjp, "launches"), ("conv1d_bwd", conv1d_vjp, "launches_bwd")]


def reset_launch_counts() -> None:
    for _, module, attr in COUNTERS:
        setattr(module, attr, 0)
    int4_matmul.launches_by_route.clear()
    group_quant_gemm.launches_by_route.clear()


def launch_counts() -> dict[str, int]:
    return {name: getattr(module, attr) for name, module, attr in COUNTERS}


# routes counted by (module, dict attribute): each key a route (G: (route, M); R: route name)
ROUTE_COUNTERS = ((int4_matmul, "launches_by_route"), (group_quant_gemm, "launches_by_route"))


def golden_classes() -> tuple:
    """The cuda-tier op and Function classes that count golden routes in their own ``golden_calls``."""
    from mojo_opset_tpu_torch.backends.cuda import functions, operators

    found = []
    for package in (operators, functions):
        for info in pkgutil.iter_modules(package.__path__):
            module = importlib.import_module(f"{package.__name__}.{info.name}")
            found += [cls for _, cls in inspect.getmembers(module, inspect.isclass)
                      if "golden_calls" in vars(cls) and cls not in found]
    return tuple(found)


def count_state() -> dict:
    """Every counter: ``(holder, attribute, key)`` -> count, ``key`` None for a scalar counter and the route for
    a by-route one."""
    state = {(module, attr, None): getattr(module, attr) for _, module, attr in COUNTERS}
    for module, attr in ROUTE_COUNTERS:
        state.update({(module, attr, key): n for key, n in getattr(module, attr).items()})
    state.update({(cls, "golden_calls", None): cls.golden_calls for cls in golden_classes()})
    return state


def credit_counts(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a ``count_state`` difference) to the counters."""
    for (holder, attr, key), n in delta.items():
        if key is None:
            setattr(holder, attr, getattr(holder, attr) + n * times)
        else:
            routes = getattr(holder, attr)
            routes[key] = routes.get(key, 0) + n * times


@contextlib.contextmanager
def recorded_counts():
    """What the block's wrappers count, taken back off the counters when it ends and left in the yielded dict
    (``count_state`` keys, nonzero differences), for ``credit_counts`` to add once per replay of what the
    block captured. The by-route dicts get back their keys and order from before the block."""
    before = count_state()
    record: dict = {}
    try:
        yield record
    finally:
        after = count_state()
        record.update({k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)})
        for (holder, attr, key), n in before.items():
            if key is None:
                setattr(holder, attr, n)
        for module, attr in ROUTE_COUNTERS:
            routes = getattr(module, attr)
            routes.clear()
            routes.update({key: n for (m, a, key), n in before.items() if m is module and a == attr})
