"""Kernel C (paged decode, its split-KV merge included) in the traced decode steps: its least time, the bytes
of the contexts it is given (every row of the batch) over the device's bandwidth, over its time on the device."""

from perfbench.work.kernels import paged_decode_bytes
from perfbench.work.model import decode_contexts, decode_steps

KERNELS = ("paged_decode_kernel", "paged_decode_merge_kernel")


def read(agg):
    part, peaks, cfg = agg.get("decode"), agg.get("peaks"), agg["config"]
    seconds = sum(s for name, s in (part or {}).get("ops", {}).items() if name.rsplit("::", 1)[-1] in KERNELS)
    if not part or not decode_steps(part) or not peaks or seconds <= 0:
        return None
    nbytes = sum(paged_decode_bytes(cfg, c) for w in part["windows"] for c in decode_contexts(w))
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / seconds
