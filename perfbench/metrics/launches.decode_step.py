"""Kernels the device ran per traced decode step (copies and fills not counted), from the profiler."""

from perfbench.work.model import decode_steps


def read(agg):
    part = agg.get("decode")
    if not part or not decode_steps(part) or not part["kernels"]:
        return None
    return part["kernels"] / decode_steps(part)
