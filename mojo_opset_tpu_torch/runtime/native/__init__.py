"""The native (C++) block allocator, bound with ctypes.

Counterpart of the JAX package's ``runtime/native/__init__.py``: the
session's reserve and release as a small shared library over numpy
buffers that the allocator never owns (the free stack and its count, the
block tables, the sequence lengths: the state the numpy fallback reads and
writes too), built
with ``$CXX`` (default ``g++``) at first use, never at import, into
``mojo_opset_tpu_torch/_build/libmojo_alloc-<hash>.so`` (the hash covers
the source and the flags). The session falls back to numpy where no
compiler builds it: ``MOJO_NATIVE=0`` forces the numpy path,
``MOJO_NATIVE=1`` requires the native one (a failed build raises).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from mojo_opset_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

SOURCE = Path(__file__).with_name("block_allocator.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_lib = None
_lib_tried = False
_build_error = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libmojo_alloc-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the allocator unless the library for this source exists; a
    failed compile raises."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile into a private directory, then rename: concurrent builds
    # never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, target.name)
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-o", lib],
                       check=True, capture_output=True, timeout=120)
        os.replace(lib, target)
    return target


def _load():
    global _lib, _lib_tried, _build_error
    if _lib_tried:
        return _lib
    with _LOCK:
        if _lib_tried:
            return _lib
        _lib_tried = True
        try:
            path = build()
        except Exception as exc:  # no toolchain, a read-only checkout, ...
            _build_error = exc
            logger.debug("native build failed (%s); using the numpy allocator", exc)
            return None
        lib = ctypes.CDLL(str(path))
        i32, ptr = ctypes.c_int32, ctypes.c_void_p  # tables go by address (see NativeBlockAllocator._tables)
        lib.mojo_alloc_create.restype = ptr
        lib.mojo_alloc_create.argtypes = [i32] * 3 + [ptr] * 2
        lib.mojo_alloc_destroy.argtypes = [ptr]
        lib.mojo_alloc_reserve.restype = i32
        lib.mojo_alloc_reserve.argtypes = [ptr] * 5
        lib.mojo_alloc_release.argtypes = [ptr, i32, ptr, ptr]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether sessions use the native allocator: off under
    ``MOJO_NATIVE=0``; else whether the library built. Under
    ``MOJO_NATIVE=1`` a library that did not build raises."""
    mode = os.environ.get("MOJO_NATIVE", "")
    if mode == "0":
        return False
    if _load() is None and mode == "1":
        raise RuntimeError(f"MOJO_NATIVE=1 but the native allocator did not build: {_build_error}")
    return _lib is not None


def _addr(arr: np.ndarray, shape: tuple) -> int:
    if arr.dtype != np.int32 or not arr.flags.c_contiguous or arr.shape != shape:
        raise ValueError(f"the allocator's tables must be C-contiguous int32 arrays of shape {shape}")
    return arr.ctypes.data


class NativeBlockAllocator:
    """ctypes handle over the C++ allocator; the caller owns the numpy tables.

    ``free_blocks`` and ``num_free`` (a one-element array) are the free
    stack: ``free_blocks[:num_free[0]]`` are free, the top handed out
    first. They are the allocator's own arrays unless the caller passes
    its buffers (the session passes its own), and they keep their
    addresses: a reset writes into them. The hand-out order is the numpy
    path's of :class:`~mojo_opset_tpu_torch.runtime.session.PagedAttentionRuntimeState`
    (rows in order), so both produce bit-identical block tables. A step's
    reserve sits between CUDA graph replays, so the call is kept short:
    the lengths in and out go through buffers of the allocator's own, and
    the addresses of the caller's tables are looked up once while the
    caller passes the same arrays.
    """

    def __init__(self, batch: int, max_blocks_per_seq: int, total_blocks: int, block_size: int,
                 free_blocks: np.ndarray = None, num_free: np.ndarray = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native allocator unavailable")
        self._lib = lib
        self.free_blocks = np.arange(total_blocks, dtype=np.int32) if free_blocks is None else free_blocks
        self.num_free = np.array([total_blocks], np.int32) if num_free is None else num_free
        self._h = lib.mojo_alloc_create(batch, max_blocks_per_seq, block_size,
                                        _addr(self.free_blocks, (total_blocks,)), _addr(self.num_free, (1,)))
        if not self._h:
            raise ValueError("bad allocator geometry")
        self._shapes = ((batch,), (batch, max_blocks_per_seq))
        self._q = np.zeros(batch, np.int32)
        self._ctx = np.zeros(batch, np.int32)
        self._q_addr, self._ctx_addr = self._q.ctypes.data, self._ctx.ctypes.data
        self._bound = (None, None, 0, 0)  # the caller's (lengths, tables) and their addresses

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mojo_alloc_destroy(h)
            self._h = None

    def _tables(self, seq_lens: np.ndarray, block_tables: np.ndarray) -> tuple:
        seq, tables, seq_addr, tables_addr = self._bound
        if seq_lens is not seq or block_tables is not tables:
            # holding the arrays keeps their addresses theirs
            self._bound = (seq_lens, block_tables, _addr(seq_lens, self._shapes[0]),
                           _addr(block_tables, self._shapes[1]))
        return self._bound[2:]

    @property
    def num_free_blocks(self) -> int:
        return int(self.num_free[0])

    def reserve(self, q_lens: np.ndarray, seq_lens: np.ndarray, block_tables: np.ndarray) -> np.ndarray:
        """Transactional batched reserve; returns the pre-reserve lengths.
        On failure nothing changes."""
        self._q[:] = q_lens
        rc = self._lib.mojo_alloc_reserve(self._h, self._q_addr, *self._tables(seq_lens, block_tables), self._ctx_addr)
        if rc == -1:
            raise ValueError("PagedAttentionRuntimeState: Out of paged KV cache memory.")
        if rc == -2:
            raise ValueError("sequence exceeds max_blocks_per_seq")
        return self._ctx.copy()

    def release(self, batch_idx: int, seq_lens: np.ndarray, block_tables: np.ndarray) -> None:
        self._lib.mojo_alloc_release(self._h, batch_idx, *self._tables(seq_lens, block_tables))
