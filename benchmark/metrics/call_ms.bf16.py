"""Host ms a frame in the bfloat16 decode entry points (benchmark spans)."""

from core import readers


def read(r):
    return readers.span_ms(r, "call.dec")
