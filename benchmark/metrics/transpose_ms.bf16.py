"""Device ms a frame of cuDNN's NCHW<->NHWC layout transposes in the traced
slice."""

from core import readers


def read(r):
    return readers.device_ms(r, "transpose")
