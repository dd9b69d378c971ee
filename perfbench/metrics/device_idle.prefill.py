"""Share of the traced prefills' wall time (each call's start to its first token on the host) in which no
operation ran on the device."""


def read(agg):
    part = agg.get("prefill")
    if not part or part["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - part["busy_s"] / part["wall_s"])
