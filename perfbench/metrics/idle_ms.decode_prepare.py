"""Device idle a traced decode step under the session's spans (``mojo.session.*`` as the innermost program span:
the reserve and the step's host arrays), in ms."""

from perfbench.spans import idle_ms


def read(agg):
    return idle_ms(agg, "mojo.session.decode_arrays", lambda name: name.startswith("mojo.session."))
