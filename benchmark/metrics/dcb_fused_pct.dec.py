"""Share of the traced slice's DepthConvBlock calls that ran the epilogue
kernels, from the measured package's `dcb.fused` and `dcb.block`
counters; None without them."""

from core import port_trace


def read(r):
    return port_trace.share_pct("dcb.fused", "dcb.block")
