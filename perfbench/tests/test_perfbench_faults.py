"""A run with the timed path broken underneath must come out not correct, once for each fault a served cell
can have: a decode step that leaves its state (the KV cache) unchanged, half of the batch left out, and a token
altered where it is produced. (The exchange between chips has no place in a one-chip cell.) On the CPU at a tiny
size, skipping the harness's look for a card."""

import time

import pytest
import torch

from perfbench import harness
from perfbench.tests.helpers import write_tiny_root


def _state_unchanged(monkeypatch):
    from mojo_opset_tpu_torch.runtime import session

    step = session.decode_step

    def unchanged(model, block_size, caches, *args):
        saved = [t.clone() for t in caches.keys + caches.values]
        out = step(model, block_size, caches, *args)
        for t, s in zip(caches.keys + caches.values, saved):
            t.copy_(s)
        return out

    monkeypatch.setattr(session, "decode_step", unchanged)


def _half_the_batch(monkeypatch):
    from mojo_opset_tpu_torch.runtime.generation import GreedySampler

    sample = GreedySampler.__call__

    def half(self, logits, session=None, generator=None):
        tokens = sample(self, logits, session, generator)
        n = tokens.shape[0] // 2
        return torch.cat([tokens[: tokens.shape[0] - n], tokens[:n]])  # the second half copies the first

    monkeypatch.setattr(GreedySampler, "__call__", half)


def _token_altered(monkeypatch):
    from mojo_opset_tpu_torch.runtime.generation import GreedySampler

    sample = GreedySampler.__call__
    calls = []

    def altered(self, logits, session=None, generator=None):
        tokens = sample(self, logits, session, generator)
        calls.append(1)
        row = len(calls) % tokens.shape[0]  # one token a step, each row in turn
        tokens = tokens.clone()
        tokens[row] = (tokens[row] + 1) % logits.shape[-1]
        return tokens

    monkeypatch.setattr(GreedySampler, "__call__", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _token_altered],
                         ids=["state-unchanged", "half-the-batch", "token-altered"])
@pytest.mark.parametrize("moe", [False, True], ids=["qwen3", "qwen3-moe"])
def test_fault_makes_the_run_not_correct(tmp_path, monkeypatch, fault, moe):
    root = write_tiny_root(tmp_path, moe=moe, batch=4)
    fault(monkeypatch)
    result = harness.run_cell(root, "tiny.cell", 2**31 + 17, 1.0, False, "cpu", time.perf_counter(),
                              log=lambda s: None)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
