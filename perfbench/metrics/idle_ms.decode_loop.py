"""Device idle a traced decode step under the generate loop itself, in ms: the innermost program span is the loop's
(``mojo.decode_step``, ``mojo.sample``, ``mojo.host_sync``) or there is none; not the graph pool's, the session's or
the hooks' (``mojo.hooks``: the harness's own time). With those three it makes up the decode steps' idle time."""

from perfbench.spans import idle_ms

ELSEWHERE = ("mojo.graph.", "mojo.session.", "mojo.hooks")


def read(agg):
    return idle_ms(agg, "mojo.decode_step", lambda name: not name.startswith(ELSEWHERE))
