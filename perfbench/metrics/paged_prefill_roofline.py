"""Kernel D (paged prefill) in the traced prefills: its least time (per sequence and layer the larger of the causal
operations over the peak rate and the bytes over the bandwidth) over its time on the device."""

from perfbench.work.kernels import paged_prefill_least_s

KERNELS = ("paged_prefill_mma", "paged_prefill_fma")


def read(agg):
    part, peaks, cfg = agg.get("prefill"), agg.get("peaks"), agg["config"]
    rate = (peaks or {}).get(f"{cfg.get('torch_dtype', 'bfloat16')}_ops_per_s")
    seconds = sum(s for name, s in (part or {}).get("ops", {}).items() if name.rsplit("::", 1)[-1] in KERNELS)
    if not part or not rate or seconds <= 0:
        return None
    least = sum(paged_prefill_least_s(cfg, w["lens"], rate, peaks["hbm_bytes_per_s"]) for w in part["windows"])
    return 100.0 * least / seconds
