"""Registers, spill bytes and blocks an SM of kernel instantiations named in one CUDA source, for any tree.

The entry points' own resource queries (``build.resources``) cover the kernels
of this tree. This tool reads another tree's kernels as well, such as the
parent commit's, before a redesign: it compiles ``SOURCE`` (a ``.cu`` file of
``mojo_opset_tpu_torch/csrc/``, with its directory on the include path) into
a program with a generated ``main`` that reports each named instantiation
through ``cudaFuncGetAttributes`` and
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, at the block size and
dynamic shared memory given, and the waves a grid of ``blocks`` makes on the
card. ``nvcc -Xptxas -v`` prints the same registers at build time.

Run on a machine with a GPU and nvcc, one spec per kernel, ``name:threads:dynamic shared bytes:grid blocks``::

    python -m mojo_opset_tpu_torch.benchmark.kernel_resources CSRC_DIR/rmsnorm_vjp.cu \\
        'rmsnorm_bwd_long_kernel<__nv_bfloat16, 8>:512:10240:264'

It prints one JSON line: the card, and for each spec its registers a thread,
spill (local) bytes, static shared bytes, blocks an SM and waves.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

from mojo_opset_tpu_torch.backends.cuda import build


def harness(source: Path, specs: list[str]) -> str:
    """The program: ``source`` included, then a main reporting each spec as a JSON object a line."""
    lines = [f'#include "{source.name}"', "#include <cstdio>", "", "template <typename K>",
             "void report(const char* name, K kernel, int threads, size_t smem, int grid) {",
             "  cudaFuncAttributes a;",
             "  if (cudaFuncGetAttributes(&a, kernel) != cudaSuccess) { printf(\"{\\\"%s\\\": null}\\n\", name); return; }",
             "  int per_sm = 0, dev = 0, sms = 0;",
             "  cudaGetDevice(&dev);",
             "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);",
             "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);",
             "  printf(\"{\\\"kernel\\\": \\\"%s\\\", \\\"regs\\\": %d, \\\"spill_bytes\\\": %zu, \\\"smem_bytes\\\": %zu, "
             "\\\"threads\\\": %d, \\\"blocks_per_sm\\\": %d, \\\"grid\\\": %d, \\\"waves\\\": %.3f}\\n\", name, "
             "a.numRegs, a.localSizeBytes, a.sharedSizeBytes, threads, per_sm, grid, "
             "per_sm ? grid / double(sms * per_sm) : 0.0);",
             "}", "", "int main() {"]
    for spec in specs:
        name, threads, smem, grid = spec.rsplit(":", 3)
        lines.append(f'  report("{name}", {name}, {int(threads)}, {int(smem)}, {int(grid)});')
    lines += ["  return 0;", "}", ""]
    return "\n".join(lines)


def main() -> None:
    if len(sys.argv) < 3:
        raise SystemExit("usage: kernel_resources.py SOURCE 'kernel<args>:threads:dyn_smem:grid' ...")
    source, specs = Path(sys.argv[1]).resolve(), sys.argv[2:]
    nvcc = build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        prog = Path(tmp) / "resources.cu"
        prog.write_text(harness(source, specs))
        exe = Path(tmp) / "resources"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-I", str(source.parent), "-o", str(exe), str(prog)], check=True)
        out = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"card": smi[0] if smi else None, "source": str(source),
                      "kernels": [json.loads(line) for line in out.splitlines() if line.strip()]}))


if __name__ == "__main__":
    main()
