"""How ``correct`` is decided: the served tokens and logits against the
plain reference.

During the window, every call watches some of its requests (``Watch``):
the longest (prompt and output together) and others drawn from the seed,
from the other half of the batch and its own in turn, up to the mix's
``check.rows_per_call``, and keeps the program's logits of those rows at
steps drawn from the seed (``check.logit_steps`` of them, the first and
each watched request's last always among them). After the window,
``sample`` draws from the seed ``check.requests`` of the watched requests
of completed calls, the longest among them and both halves of the batch,
and ``compare`` runs the reference once over each prompt with the tokens
it was served (its first ``outs[i]``), at the served sizes, and reads two
numbers:

* ``gap``: the widest gap by which a served token's reference logit lies
  below the reference's best logit at its position (greedy tokens);
* ``logit_err``: the worst relative L2 distance ||program - reference|| /
  ||reference|| of the kept logits rows.

With ``control=True`` it also reads them for the control: the reference in
float8 put in the program's place (its own argmax tokens, its logits).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


class Watch:
    """Which rows and steps of each call keep their logits, and the kept logits."""

    def __init__(self, mix: dict, seed: int, device):
        spec = mix["check"]
        self.batch = int(mix["batch"])
        self.rows_per_call = min(int(spec["rows_per_call"]), self.batch)
        self.logit_steps = int(spec["logit_steps"])
        self.seed = int(seed)
        self.device = device
        self.plan: Dict[int, tuple] = {}  # call -> (rows, kept steps, the rows as a device tensor)
        self.kept: Dict[int, Dict[int, torch.Tensor]] = {}  # call -> step -> (rows, V) logits

    def begin(self, call: int, lens: np.ndarray, outs: np.ndarray) -> None:
        rng = np.random.default_rng([self.seed, 11, call])
        longest = int(np.argmax(np.asarray(lens) + np.asarray(outs)))
        rows = _halves_in_turn(longest, [r for r in rng.permutation(self.batch).tolist() if r != longest],
                               lambda r: 2 * r >= self.batch)[: self.rows_per_call]
        last = {int(outs[r]) - 1 for r in rows}
        middle = rng.permutation(np.arange(1, int(max(outs)) - 1))[: max(self.logit_steps - 1 - len(last), 0)]
        steps = {0, *last, *middle.tolist()}
        self.plan[call] = (rows, steps, torch.tensor(rows, device=self.device))
        self.kept[call] = {}

    def keep(self, call: int, step: int, logits: torch.Tensor) -> None:
        if call not in self.plan:
            return
        _, steps, index = self.plan[call]
        if step in steps:
            self.kept[call][step] = logits.index_select(0, index)


def _halves_in_turn(first, others, half) -> list:
    """``first``, then ``others`` in their order but taken from the other half
    of the batch than ``first`` and from its own in turn."""
    other = [x for x in others if half(x) != half(first)]
    same = [x for x in others if half(x) == half(first)]
    turns = [x for pair in zip(other, same) for x in pair]
    return [first] + turns + other[len(same):] + same[len(other):]


def sample(calls: List[dict], watch: Watch, count: int, seed: int) -> List[dict]:
    """``count`` watched requests of completed calls, drawn from the seed, the
    longest (prompt and output) first and then from the other half of the
    batch and its own in turn (so that a fault in either half shows): each a
    dict with the prompt ids, the served tokens and the kept logits by step."""
    found = []
    for c in calls:
        if not c["complete"]:
            continue
        rows = watch.plan[c["index"]][0]
        starts = np.concatenate([[0], np.cumsum(c["lens"])])
        for i, r in enumerate(rows):
            out = int(c["outs"][r])
            found.append({
                "half": 2 * r >= c["batch"],
                "prompt": c["ids"][starts[r]:starts[r + 1]],
                "tokens": c["tokens"][r][:out],
                "logits": {s: v[i] for s, v in watch.kept[c["index"]].items() if s < out},
            })
    if not found:
        return []
    longest = max(range(len(found)), key=lambda i: found[i]["prompt"].size + found[i]["tokens"].size)
    rest = [i for i in np.random.default_rng([seed, 12]).permutation(len(found)).tolist() if i != longest]
    return [found[i] for i in _halves_in_turn(longest, rest, lambda i: found[i]["half"])[:count]]


def _gap(ref: torch.Tensor, tokens: torch.Tensor) -> float:
    """Widest gap by which ``tokens``' logits lie below each row's best."""
    return float((ref.max(dim=-1).values - ref.gather(1, tokens[:, None].long())[:, 0]).max())


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b).norm() / b.norm())


def compare(reference, cfg: dict, seed: int, requests: List[dict], device, control: bool = False) -> dict:
    """The compared numbers of ``requests`` (from ``sample``): ``{"gap": x,
    "logit_err": y}``, and with ``control`` the control's under
    ``control_gap`` and ``control_logit_err``."""
    sequences = [torch.as_tensor(np.concatenate([r["prompt"], r["tokens"][:-1]]).astype(np.int64))
                 for r in requests]
    first = [r["prompt"].size - 1 for r in requests]
    precisions = ("fp32", "fp8") if control else ("fp32",)
    logits = reference.forward_logits(cfg, seed, sequences, first, device, precisions)
    out = {"gap": 0.0, "logit_err": 0.0}
    if control:
        out.update(control_gap=0.0, control_logit_err=0.0)
    for r, rows in zip(requests, logits):
        ref = rows["fp32"]
        tokens = torch.as_tensor(np.asarray(r["tokens"], np.int64))
        out["gap"] = max(out["gap"], _gap(ref, tokens))
        for step, kept in r["logits"].items():
            out["logit_err"] = max(out["logit_err"], _rel(kept.cpu(), ref[step]))
        if control:
            low = rows["fp8"]
            out["control_gap"] = max(out["control_gap"], _gap(ref, low.argmax(dim=-1)))
            for step in r["logits"]:
                out["control_logit_err"] = max(out["control_logit_err"], _rel(low[step], ref[step]))
    return out
