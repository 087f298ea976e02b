"""Share of the traced slice's frames through DMC's device-EC decoder body
that replayed from a CUDA graph, from the measured package's
`graph.replay` and `graph.call` counters; None without them."""

from core import port_trace


def read(r):
    return port_trace.share_pct("graph.replay", "graph.call")
