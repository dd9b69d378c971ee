"""The traced prefills' model operations (causal attention counted per sequence) over their wall time, from each
call's start to its first token on the host, at the device's peak rate in the model's dtype."""

from perfbench.work.model import prefill_ops


def read(agg):
    part, peaks, cfg = agg.get("prefill"), agg.get("peaks"), agg["config"]
    rate = (peaks or {}).get(f"{cfg.get('torch_dtype', 'bfloat16')}_ops_per_s")
    if not part or not part["windows"] or not rate:
        return None
    return 100.0 * sum(prefill_ops(cfg, w["lens"]) for w in part["windows"]) / (part["wall_s"] * rate)
