"""opendcvc_tpu_torch — the PyTorch/CUDA port of the JAX package beside it.

Module names mirror the JAX package's, which stays the reference.
Internally the port is NCHW; its public entry points take and return NHWC
frames (1, H, W, 3), as the JAX package does.  The lane rANS
scans are hand-written CUDA kernels (`csrc/`, built at first use by
`ops/_build.py`).

Determinism: the encoder and the decoder evaluate the shared stages in
separate calls, and the temporal feature chain needs their numerics to be
bit-identical.  cuDNN runs float32 convolutions in TF32 by default and may
pick algorithms by timing; both would let the two sides drift.  These pins
are the counterpart of the JAX package's excess-precision pin and its
HIGHEST conv precision.
"""

import torch as _torch

_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.deterministic = True
_torch.backends.cudnn.benchmark = False

del _torch
