"""Device ms a frame of elementwise kernels (ATen's and the epilogue
kernels) in the traced slice."""

from core import readers


def read(r):
    return readers.device_ms(r, "elementwise")
