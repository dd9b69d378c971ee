"""Share of the traced decode steps' wall time in which no operation ran on the device."""


def read(agg):
    part = agg.get("decode")
    if not part or part["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - part["busy_s"] / part["wall_s"])
