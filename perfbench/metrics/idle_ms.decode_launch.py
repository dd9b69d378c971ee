"""Device idle a traced decode step under the graph pool's spans (``mojo.graph.*`` as the innermost program span:
the runner's lookup, the copies into the graph's static buffers, its launch, the outputs' clone), in ms."""

from perfbench.spans import idle_ms


def read(agg):
    return idle_ms(agg, "mojo.graph.replay", lambda name: name.startswith("mojo.graph."))
