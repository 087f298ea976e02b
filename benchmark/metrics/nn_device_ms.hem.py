"""Device ms a frame of every operation but copies and the lane rANS
kernels, in the traced slice."""

from core import readers


def read(r):
    return readers.nn_device_ms(r)
