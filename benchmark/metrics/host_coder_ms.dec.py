"""Host ms a frame in the host rANS coder's calls (benchmark timers)."""

from core import readers


def read(r):
    return readers.span_ms(r, "host_coder")
