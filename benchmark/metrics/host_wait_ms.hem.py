"""Host ms a frame of the traced slice spent waiting for the device, read
from the measured package's own `wait.*` spans (its trace's last session):
four fetches of CDF indexes a P-frame, two an I-frame."""

from core import port_trace


def read(r):
    return port_trace.spans_ms("wait.")
