"""The end-to-end arithmetic over a window, and a stall that must move both the rate and the tail."""

import numpy as np
import pytest

from perfbench import e2e


def _window(stall_every=0, stall_s=0.0, steps=200, step_s=0.01, batch=4, calls=3):
    """``calls`` calls of ``steps`` tokens ``step_s`` apart, after a 0.05 s prefill."""
    out, t = [], 0.0
    for _ in range(calls):
        start, stamps = t, []
        t += 0.05
        for i in range(steps):
            t += step_s + (stall_s if stall_every and i % stall_every == stall_every - 1 else 0.0)
            stamps.append(t)
        out.append({"start": start, "stamps": stamps, "outs": [steps] * batch, "complete": True})
    return out, t


def test_rate_and_tails_by_hand():
    calls, t_close = _window()
    assert e2e.output_tok_s(calls, 0.0, t_close) == pytest.approx(3 * 200 * 4 / t_close)
    assert e2e.itl_p95_ms(calls, 0.0, t_close) == pytest.approx(10.0)
    assert e2e.ttft_p95_ms(calls, 0.0, t_close) == pytest.approx(60.0)


def test_injected_stall_moves_rate_and_p95():
    calm, close_calm = _window()
    stalled, close_stalled = _window(stall_every=10, stall_s=0.02)  # every 10th step 20 ms late
    seconds = close_calm  # the same window length for both
    calm_rate = e2e.output_tok_s(calm, 0.0, seconds)
    in_window = [dict(c, stamps=[s for s in c["stamps"] if s <= seconds]) for c in stalled]
    assert e2e.output_tok_s(in_window, 0.0, seconds) < 0.9 * calm_rate
    assert e2e.itl_p95_ms(in_window, 0.0, seconds) > 2.5 * e2e.itl_p95_ms(calm, 0.0, seconds)


def test_ttft_counts_requests_done_in_the_window_each_once():
    calls, t_close = _window(batch=2)
    calls[0]["stamps"][0] = calls[0]["start"] + 1.0
    calls[1]["stamps"] = calls[1]["stamps"][:150]  # cut by the window: its requests are not done
    calls[2]["outs"] = [100, 300]  # one request done, one wanting more than the call ran
    expected = float(np.percentile([1000, 1000, 60], 95))
    assert e2e.ttft_p95_ms(calls, 0.0, t_close) == pytest.approx(expected)


def test_requests_of_a_static_batch_are_served_their_own_lengths():
    """Request i counts its first outs[i] tokens and the gaps between them; the batch runs on to its longest."""
    calls, t_close = _window(batch=2, calls=1, steps=10)
    calls[0]["outs"] = [4, 10]
    assert e2e.output_tok_s(calls, 0.0, t_close) == pytest.approx(14 / t_close)
    gaps = [10.0] * (3 + 9)  # 3 gaps of the short request, 9 of the long
    assert e2e.itl_p95_ms(calls, 0.0, t_close) == pytest.approx(float(np.percentile(gaps, 95)))
    calls[0]["stamps"][5] += 0.5  # a stall after the short request is done is felt by the long one alone
    calls[0]["stamps"][6:] = [s + 0.5 for s in calls[0]["stamps"][6:]]
    slow = e2e.itl_p95_ms(calls, 0.0, t_close + 1)
    assert slow > 10.0 and e2e.output_tok_s(calls, 0.0, t_close + 1) == pytest.approx(14 / (t_close + 1))


def test_no_samples_leave_the_metric_out():
    out = e2e.end_to_end(["output_tok_s", "itl_p95_ms", "ttft_p95_ms", "setup_s"], [], 0.0, 1.0, 3.5)
    assert out == {"setup_s": 3.5}
