"""The traced decode steps' model operations over their wall time at the device's peak rate in the model's dtype:
every row still served through the weights it needs (a MoE row through ``num_experts_per_tok`` experts, whichever
they are) and attention over each sequence's own length at each step. A row whose request is done is work the
static batch does and nobody needs: not counted."""

from perfbench.work.model import decode_contexts, decode_step_ops, decode_steps


def read(agg):
    part, peaks, cfg = agg.get("decode"), agg.get("peaks"), agg["config"]
    rate = (peaks or {}).get(f"{cfg.get('torch_dtype', 'bfloat16')}_ops_per_s")
    if not part or not decode_steps(part) or not rate:
        return None
    ops = sum(decode_step_ops(cfg, c) for w in part["windows"] for c in decode_contexts(w, served_only=True))
    return 100.0 * ops / (part["wall_s"] * rate)
