"""The port's host<->device copies: one function copies to the host, one
copies to the device, and each counts its bytes in the trace.

    from opendcvc_tpu_torch.utils.transfer import fetch_async, upload
    wait = fetch_async(t)          # the copy starts; the device runs on
    arr = wait()                   # numpy, in the span `wait.fetch`
    t = upload(arr, device)        # pinned, non-blocking; span `upload`

Counters (utils/trace.py): `d2h_bytes` the bytes each fetch_async moves,
`h2d_bytes` those each upload moves, on the CPU as on CUDA.
"""

import numpy as np
import torch

from . import trace


def fetch_async(t, wait="wait.fetch"):
    """Start copying a tensor to the host; returns a callable that waits
    for the copy and returns it as numpy, in the trace span `wait`.  A
    CUDA copy lands in pinned memory behind an event, so the device queue
    runs on meanwhile; the callable holds the pinned buffer, and the
    caching host allocator keeps it from reuse until the copy's event has
    passed."""
    trace.count("d2h_bytes", t.nbytes)
    if t.device.type != "cuda":
        def done():
            with trace.wait(wait):
                return t.numpy()
        return done
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()

    def done():
        with trace.wait(wait):
            event.synchronize()
        return host.numpy()

    return done


@trace.spanned("upload")
def upload(a, device):
    """numpy array or host tensor -> tensor on `device`; a CUDA upload
    goes through pinned memory and does not wait for the device."""
    t = a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))
    trace.count("h2d_bytes", t.nbytes)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
