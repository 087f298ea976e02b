"""Share of the traced slice's windowed encode copies whose payload overran
the window and crossed again in full, from the measured package's
`slim.miss` and `slim.fetch` counters; None without windowed copies."""

from core import port_trace


def read(r):
    return port_trace.share_pct("slim.miss", "slim.fetch")
