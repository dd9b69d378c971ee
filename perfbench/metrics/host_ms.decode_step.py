"""The host's own time a traced decode step, in ms: ``mojo.decode_step``'s time less the time of its reads of the
tokens to the host (``mojo.host_sync``, which wait for the device) and of the hooks (``mojo.hooks``, the harness's
own; the window's, so the microseconds of the hook that opens it too). Once a step's launch overlaps the device's
work, a step takes no less than this."""

from perfbench.spans import decode


def read(agg):
    found = decode(agg, "mojo.decode_step")
    if found is None:
        return None
    part, steps = found
    s = {name: part["spans"].get(name, {}).get("s", 0.0) for name in ("mojo.decode_step", "mojo.host_sync",
                                                                       "mojo.hooks")}
    return 1e3 * (s["mojo.decode_step"] - s["mojo.host_sync"] - s["mojo.hooks"]) / steps
