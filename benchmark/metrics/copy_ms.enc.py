"""Device ms a frame of host<->device copies in the traced slice."""

from core import readers


def read(r):
    return readers.device_ms(r, "upload", "fetch")
