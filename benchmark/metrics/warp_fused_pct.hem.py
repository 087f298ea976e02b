"""Share of the traced slice's `ops/warp.py::flow_warp` calls that ran on
the bilinear-warp kernel W1, from the measured package's `warp.fused`
and `warp.call` counters; None without them."""

from core import port_trace


def read(r):
    return port_trace.share_pct("warp.fused", "warp.call")
