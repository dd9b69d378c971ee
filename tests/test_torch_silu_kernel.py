"""Kernel L's index map on the CPU.

``csrc/silu.cu`` covers a tensor of n elements once. When its pointers are
16-byte aligned, one grid of ``ceil(n_vec / (U * THREADS))`` blocks (at
least one) takes the ``n_vec = n // V`` 16-byte vectors: thread t of block
b owns vectors ``b * THREADS * U + u * THREADS + t`` for u < U, and the
last block's first ``n - n_vec * V`` threads take the scalar tail. An
unaligned tensor takes a grid-stride scalar loop over at most 132 x 16
blocks of 256 threads. ``vector_cover`` and ``scalar_cover`` repeat those
maps and count how often each element is reached: exactly once, for every
launch shape the kernel instantiates, every element width, ragged tails
and the train step's (4096, 9728) activation. The wrapper's launch shape
must be one the source instantiates.
"""

import re

import numpy as np
import pytest

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels import silu_vjp

SCALAR_THREADS, SCALAR_MAX_BLOCKS = 256, 132 * 16


def _cdiv(a, b):
    return -(-a // b)


def instantiated_shapes():
    """The (U, THREADS) pairs of csrc/silu.cu's MOJO_SILU_CONFIG."""
    src = (build.CSRC_DIR / "silu.cu").read_text()
    return {(int(u), int(t)) for u, t in re.findall(r"\(unroll\) == (\d) && \(threads\) == (\d+)", src)}


def vector_cover(n, itemsize, unroll, threads):
    """How often the vector route reaches each of n elements."""
    V = 16 // itemsize
    n_vec = n // V
    grid = max(1, _cdiv(n_vec, unroll * threads))
    b, u, t = np.meshgrid(np.arange(grid), np.arange(unroll), np.arange(threads), indexing="ij")
    vec = (b * threads * unroll + u * threads + t).ravel()
    vec = vec[vec < n_vec]
    count = np.bincount((vec[:, None] * V + np.arange(V)).ravel(), minlength=n)
    tail = n_vec * V + np.arange(threads)  # the last block's threads
    count += np.bincount(tail[tail < n], minlength=n)
    assert n - n_vec * V < V <= threads  # the tail fits in one block
    return count


def scalar_cover(n):
    grid = min(_cdiv(n, SCALAR_THREADS), SCALAR_MAX_BLOCKS)
    first = np.arange(grid * SCALAR_THREADS)
    idx = np.concatenate([np.arange(i, n, grid * SCALAR_THREADS) for i in first[first < n]] or [np.zeros(0, int)])
    return np.bincount(idx, minlength=n)


def test_the_wrappers_launch_shape_is_instantiated():
    shapes = instantiated_shapes()
    assert shapes == {(u, t) for u in (2, 4) for t in (128, 256, 512)}
    assert (silu_vjp.UNROLL, silu_vjp.THREADS) in shapes


@pytest.mark.parametrize("itemsize", [2, 4], ids=["16-bit", "fp32"])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 1001, 77 * 129, 2 * 128 * 8, 2 * 128 * 8 + 5, 4 * 512 * 8 * 3 - 1])
def test_vector_route_reaches_every_element_once(n, itemsize):
    for unroll, threads in sorted(instantiated_shapes()):
        count = vector_cover(n, itemsize, unroll, threads)
        assert count.shape == (n,) and (count == 1).all(), (unroll, threads)


def test_vector_route_covers_the_train_steps_activation_once():
    n = 4096 * 9728
    count = vector_cover(n, 2, silu_vjp.UNROLL, silu_vjp.THREADS)
    assert (count == 1).all()
    assert _cdiv(n // 8, silu_vjp.UNROLL * silu_vjp.THREADS) * silu_vjp.UNROLL * silu_vjp.THREADS * 8 >= n


@pytest.mark.parametrize("n", [1, 255, 256, 1001, 77 * 129, SCALAR_THREADS * SCALAR_MAX_BLOCKS + 3])
def test_unaligned_route_reaches_every_element_once(n):
    assert (scalar_cover(n) == 1).all()
