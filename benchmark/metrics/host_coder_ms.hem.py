"""Host ms a frame of the traced slice in the host coder's calls, read from
the measured package's own `coder.*` spans (its trace's last session)."""

from core import port_trace


def read(r):
    return port_trace.spans_ms("coder.")
