"""Build the port's CUDA kernels at first use and bind them with ctypes.

All sources under ``mojo_opset_tpu_torch/csrc/`` compile into
``_build/libmojo_kernels-<hash>.so``: one ``nvcc -c`` per ``.cu`` file, all
started together, then one link. The hash covers the sources and the
flags, so an edited kernel rebuilds and an unchanged one loads from disk. Each entry point is ``extern "C"``: raw pointers, ints
and floats, the CUDA stream last; it returns ``cudaGetLastError()``.

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# kernel J's scalar tail: B, Tq, Tk, hq, hkv, D, scale, causal, lws, gws, abab, dtype, stream
_SWA_TAIL = (_I,) * 6 + (_F,) + (_I,) * 5 + (_P,)
# kernel O's: B, hq, hkv, Sq, Sk, D, the mask's four strides, scale
_DIFF_TAIL = (_I,) * 6 + (_L,) * 4 + (_F,)
# argument types of every entry point, the trailing stream included
SIGNATURES = {
    "mojo_flash_swa_fwd": (_P,) * 7 + _SWA_TAIL,
    "mojo_flash_swa_dq": (_P,) * 10 + _SWA_TAIL,
    "mojo_flash_swa_dkv": (_P,) * 10 + _SWA_TAIL,
    "mojo_flash_diffusion_fwd": (_P,) * 6 + _DIFF_TAIL + (_F, _I, _P),
    "mojo_flash_diffusion_dq": (_P,) * 9 + _DIFF_TAIL + (_I, _P),
    "mojo_flash_diffusion_dkv": (_P,) * 9 + _DIFF_TAIL + (_I, _P),
    "mojo_rmsnorm": (_P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _P),
    "mojo_residual_add_rmsnorm": (_P,) * 5 + (_I, _I, _F) + (_I,) * 4 + (_P,),
    "mojo_rope_token_first": (_P,) * 6 + (_I,) * 7 + (_P,),
    "mojo_paged_decode": (_P,) * 9 + (_I,) * 10 + (_F,) + (_I,) * 5 + (_P,),
    "mojo_paged_prefill": (_P,) * 9 + (_I,) * 10 + (_F, _I, _I, _I, _P),
    "mojo_rmsnorm_quant": (_P,) * 5 + (_I, _I, _F, _F, _F, _I, _I, _I, _I, _P),
    "mojo_int8_matmul": (_P,) * 7 + (_I,) * 7 + (_P,),
    "mojo_int4_matmul": (_P,) * 7 + (_I,) * 7 + (_P,),
    "mojo_group_gemm": (_P,) * 5 + (_L,) + (_I,) * 6 + (_P,),
    "mojo_group_quant_gemm": (_P,) * 6 + (_I,) * 7 + (_P,),
    "mojo_mla_decode": (_P,) * 10 + (_I,) * 9 + (_P,),
    "mojo_rmsnorm_bwd": (_P,) * 6 + (_I, _I, _F) + (_I,) * 5 + (_P,),
    "mojo_silu_fwd": (_P, _P, _L) + (_I,) * 4 + (_P,),
    "mojo_silu_bwd": (_P, _P, _P, _L) + (_I,) * 4 + (_P,),
    "mojo_rope_head_first": (_P,) * 7 + (_I,) * 9 + (_P,),
    "mojo_flce_stats": (_P,) * 7 + (_I,) * 4 + (_F, _I, _P),
    "mojo_flce_dz": (_P,) * 7 + (_I,) * 5 + (_F, _F, _I, _P),
    "mojo_flce_dx": (_P,) * 4 + (_I,) * 6 + (_P,),
    "mojo_flce_dw": (_P,) * 4 + (_I,) * 6 + (_P,),
    "mojo_conv1d_fwd": (_P,) * 5 + (_I,) * 12 + (_P,),
    "mojo_conv1d_bwd": (_P,) * 8 + (_I,) * 12 + (_P,),
    # the resource queries (``resources``): ints in, an int[4] out last in place of the stream
    "mojo_rmsnorm_bwd_resources": (_I,) * 5 + (_P,),
    "mojo_conv1d_resources": (_I,) * 7 + (_P,),
}

_CUDA_ERRORS = {
    1: "cudaErrorInvalidValue",
    2: "cudaErrorMemoryAllocation",
    9: "cudaErrorInvalidConfiguration",
    98: "cudaErrorInvalidDeviceFunction",
    209: "cudaErrorNoKernelImageForDevice",
    700: "cudaErrorIllegalAddress",
    719: "cudaErrorLaunchFailure",
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, /usr/local/cuda/bin): the cuda tier's kernels are built "
            "from mojo_opset_tpu_torch/csrc with the CUDA toolkit at first use. "
            "Tensors on the CPU need no build; MOJO_BACKEND=ref selects the plain tier."
        )
    return nvcc


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmojo_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    target = library_path()
    if target.exists():
        return target
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile into a private directory, then rename the library: concurrent
    # builders never load a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects, procs = [], []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            objects.append(obj)
            procs.append((src.name, subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)])))
        failed = [name for name, proc in procs if proc.wait() != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        lib = os.path.join(tmp, target.name)
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objects], check=True)
        os.replace(lib, target)
    return target


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` on ``device``'s current stream; raise on a
    non-zero CUDA error."""
    lib = load_library()
    with torch.cuda.device(device):
        rc = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({_CUDA_ERRORS.get(rc, 'see cudaError_t')})")


def resources(name: str, *args) -> dict:
    """What the kernel that entry point ``name`` picks for ``args`` takes on
    the current card: registers a thread, blocks an SM, spill (local) bytes
    a thread and static shared bytes a block."""
    out = (ctypes.c_int * 4)()
    rc = getattr(load_library(), name)(*args, out)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({_CUDA_ERRORS.get(rc, 'see cudaError_t')})")
    return dict(zip(("regs", "blocks_per_sm", "spill_bytes", "smem_bytes"), out))


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32, float16 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


H100_SMS = 132  # what a tensor on the meta device (shape checks only) counts


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device``: shapes of kernel grids are
    sized from it, never from tensor values."""
    if device.type != "cuda":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def require(cond: bool, msg: str) -> None:
    """Input check of a kernel wrapper: a ValueError the caller can act on."""
    if not cond:
        raise ValueError(msg)


def require_no_grad(name: str, *tensors) -> None:
    """Check of a forward-only kernel's wrapper: a ctypes launch records no
    autograd graph, so an input that needs a gradient would lose it
    silently. Raises when grad mode is on and one does."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is a forward-only kernel and an input requires grad: its output would carry no gradient. "
            f"Run it under torch.no_grad() or torch.inference_mode(), or train through the golden ops "
            f"(MOJO_BACKEND=ref) or a Mojo*Function."
        )


def require_device(device: torch.device, *tensors: torch.Tensor) -> None:
    for t in tensors:
        require(t.device == device, f"all inputs must be on {device}, got a tensor on {t.device}")
