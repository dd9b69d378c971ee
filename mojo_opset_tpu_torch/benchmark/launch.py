"""Multi-device benchmark launcher.

Counterpart of the JAX package's ``benchmark/launch.py`` (:33-225), in two
modes:

* **per-device fan-out** (``--mode device``): one ``run_perf`` subprocess
  for each visible card, pinned by ``MOJO_LAUNCH_DEVICE``, at once or one
  after another (``--serial``); their records are merged with a ``device``
  field.
* **mesh sweep** (``--mode mesh``): the four compute+comm ops
  (``MojoGemmAllReduce``, ``MojoAllGatherGemm``, ``MojoGemmReduceScatter``,
  ``MojoGemmAll2All``) on a ``torch.distributed`` group of N processes
  (``parallel.mesh.init_distributed``: NCCL on cards, gloo on the CPU,
  rendezvous through a file), each rank holding the shard JAX's
  ``shard_map`` ``in_specs`` give it (:120-187), timed by ``timing.py``
  with chains that double in step on every rank (``timed_us``'s
  ``agree``: the ranks' collectives pair up); rank 0 writes the record,
  ``provider`` the group's backend.

Usage::

    python -m mojo_opset_tpu_torch.benchmark.launch --preset smoke --json out.json
    python -m mojo_opset_tpu_torch.benchmark.launch --mode mesh --num-devices 4

Both run on the card unless ``--device cpu`` asks for the CPU (the mesh
then runs over gloo at small shapes: a wiring check, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List

import torch

PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])  # the directory that holds mojo_opset_tpu_torch
MESH_TIMEOUT_S = 600  # a rank that waits on a collective its peer never makes is killed after this

def _device_count(args) -> int:
    if args.num_devices:
        return args.num_devices
    if args.device == "cpu":
        return 1
    count = torch.cuda.device_count()
    if count == 0:
        raise SystemExit("no CUDA device: the launcher runs on the cards; pass --device cpu to run on the CPU")
    return count


def _per_device_sweep(args) -> List[dict]:
    """One run_perf subprocess a device; their JSON records merged."""
    n = _device_count(args)
    procs, outs = [], []
    with tempfile.TemporaryDirectory(prefix="mojo_launch_") as tmp:
        for dev in range(n):
            outs.append(os.path.join(tmp, f"dev{dev}.json"))
            cmd = [sys.executable, "-m", "mojo_opset_tpu_torch.benchmark.run_perf", "--preset", args.preset,
                   "--providers", args.providers, "--iters", str(args.iters), "--json", outs[-1],
                   "--device", args.device]
            if args.ops:
                cmd += ["--ops", args.ops]
            paths = (PACKAGE_ROOT, os.environ.get("PYTHONPATH"))
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, paths)))
            if args.device != "cpu":
                env["MOJO_LAUNCH_DEVICE"] = str(dev)
            procs.append(subprocess.Popen(cmd, env=env))
            if args.serial:
                procs[-1].wait()
        results: List[dict] = []
        for dev, (proc, path) in enumerate(zip(procs, outs)):
            rc = proc.wait()
            if rc != 0:
                raise RuntimeError(f"device {dev}: run_perf exited with rc={rc}")
            with open(path) as f:
                results += [{**rec, "device": dev} for rec in json.load(f)]
    return results


# -- mesh sweep -----------------------------------------------------------

def _mesh_cases(device: torch.device):
    """(op name, M rows a shard, K, N): full sizes on the card, small ones
    on the CPU (JAX :80-93)."""
    m_, k = (4096, 4096) if device.type == "cuda" else (256, 512)
    return [
        ("GemmAllReduce", m_, k, k),
        ("AllGatherGemm", m_ // 4, k, k),
        ("GemmReduceScatter", m_, k, k),
        ("GemmAll2All", m_ // 4, k, k),
    ]


def _mesh_op(name: str, rows: int, K: int, N: int, n: int, rank: int, group, device: torch.device):
    """This rank's op, its input shard and the case's flops (JAX
    :120-187's in_specs: ``P(None, "tp")`` a K shard, ``P("tp", None)`` a
    row shard)."""
    import mojo_opset_tpu_torch as m

    dtype = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    if name in ("GemmAllReduce", "GemmReduceScatter"):  # K sharded; every rank (M, K/n) x (N, K/n)
        x, w = randn(rows, K), randn(N, K)
        cols = slice(rank * K // n, (rank + 1) * K // n)
        cls = m.MojoGemmAllReduce if name == "GemmAllReduce" else m.MojoGemmReduceScatter
        return cls(w[:, cols].contiguous(), group=group), x[:, cols].contiguous(), 2 * rows * K * N
    if name == "AllGatherGemm":  # rows sharded (M/n a rank), the whole weight
        x, w = randn(rows * n, K), randn(N, K)
        shard = x[rank * rows:(rank + 1) * rows].contiguous()
        return m.MojoAllGatherGemm(w, group=group, gather_dim=0), shard, 2 * rows * n * K * N
    H = n * 4  # GemmAll2All, Ulysses: seq-sharded (M/n, H*128) -> head-sharded (M, H*128/n)
    x, w = randn(rows * n, K), randn(H * 128, K)
    shard = x[rank * rows:(rank + 1) * rows].contiguous()
    op = m.MojoGemmAll2All(w, group=group, scatter_dim=1, gather_dim=0)
    return op, shard, 2 * rows * n * K * H * 128


def _all_stop(stop: bool, group, device: torch.device) -> bool:
    """Whether every rank of ``group`` would stop doubling its chains."""
    import torch.distributed as dist

    go_on = torch.tensor([0 if stop else 1], dtype=torch.int32, device=device)  # NCCL reduces device tensors
    dist.all_reduce(go_on, op=dist.ReduceOp.MAX, group=group)
    return not bool(go_on.item())


def _mesh_rank(rank: int, n: int, rdv: str, device_type: str, ops, iters: int, out_path: str) -> None:
    """One rank of the mesh sweep (a spawned process)."""
    import torch.distributed as dist

    from mojo_opset_tpu_torch.benchmark.timing import timed_us
    from mojo_opset_tpu_torch.parallel.mesh import init_distributed

    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cpu":
        torch.set_num_threads(1)
    device = init_distributed(rank, n, rdv, device=device)
    group = dist.group.WORLD
    backend = dist.get_backend(group)
    results = []
    try:
        for name, rows, K, N in _mesh_cases(device):
            if ops and name not in ops:
                continue
            op, shard, flops = _mesh_op(name, rows, K, N, n, rank, group, device)
            with torch.no_grad():
                # eager launches, and the chains double until every rank would stop: every rank makes the same
                # calls, so the collectives pair up
                us, timer = timed_us(op, shard, iters=iters, repeats=3, warmup=1, device=device, graph=False,
                                     agree=lambda stop: _all_stop(stop, group, device))
            results.append({"op": name, "case": f"mesh{n}_m{rows}_k{K}_n{N}", "provider": backend, "devices": n,
                            # run_perf's decimals: the timer floors a marginal lost in noise at 1e-3 us, which 2
                            # would round to 0, and a slow host's rate would round to 0 at 3
                            "us": round(us, 3), "timing": timer, "tflops": round(flops / (us * 1e-6) / 1e12, 6)})
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)


def _mesh_sweep(args) -> List[dict]:
    n = _device_count(args)
    if args.device != "cpu" and torch.cuda.device_count() < n:
        raise SystemExit(f"mesh sweep needs {n} cards, have {torch.cuda.device_count()}")
    ops = set(args.ops.split(",")) if args.ops else None
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mojo_mesh_") as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        rdv = "file://" + os.path.join(tmp, "rdv")
        procs = [ctx.Process(target=_mesh_rank, args=(r, n, rdv, args.device, ops, args.iters, out_path))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MESH_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if alive:
            raise RuntimeError(f"mesh sweep: ranks {alive} still ran after {MESH_TIMEOUT_S} s")
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if failed:
            raise RuntimeError(f"mesh sweep: ranks exited with {failed}")
        with open(out_path) as f:
            results = json.load(f)
    for rec in results:
        print(rec)
    return results


def main(argv=None) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", default="mesh", choices=["device", "mesh", "both"])
    parser.add_argument("--num-devices", type=int, default=None)
    parser.add_argument("--ops", default=None)
    parser.add_argument("--providers", default="ref,cuda")
    parser.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--serial", action="store_true", help="run the per-device sweeps one at a time")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--json", default=None)
    args = parser.parse_args(argv)

    results: List[dict] = []
    if args.mode in ("device", "both"):
        results += _per_device_sweep(args)
    if args.mode in ("mesh", "both"):
        results += _mesh_sweep(args)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
