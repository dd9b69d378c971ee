"""Kernel H (the grouped expert GEMM, its row-tile table included) on the device per traced decode step, in ms."""

from perfbench.work.model import decode_steps

KERNELS = ("gmm_mma_kernel", "gmm_wgmma_kernel", "gmm_fma_kernel", "group_tile_table")


def read(agg):
    part = agg.get("decode")
    seconds = sum(s for name, s in (part or {}).get("ops", {}).items() if name.rsplit("::", 1)[-1] in KERNELS)
    if not part or not decode_steps(part) or seconds <= 0:
        return None
    return 1e3 * seconds / decode_steps(part)
