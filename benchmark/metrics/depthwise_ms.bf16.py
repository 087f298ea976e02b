"""Device ms a frame of depthwise 3x3 convolutions in the traced slice."""

from core import readers


def read(r):
    return readers.device_ms(r, "depthwise")
