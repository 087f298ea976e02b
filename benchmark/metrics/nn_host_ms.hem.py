"""Host ms a frame of the traced slice in the measured package's own
`nn.*` stage spans (its trace's last session): the host's time to queue
the NN stages, and to wait where a stage needs the device; nothing where
the package has no such span."""

from core import port_trace


def read(r):
    s = port_trace.session()
    if s is None or not any(n.startswith("nn.") for n in s["spans"]):
        return None
    return port_trace.spans_ms("nn.")
