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

In bfloat16 (`dtype=torch.bfloat16` on DMC and DMCI) the same pins keep
the two sides equal: cuDNN stays deterministic with benchmark=False, so
its algorithm is a function of the call's shapes, dtypes and strides,
and the encoder and the decoder call each shared stage on tensors equal
in all three; TF32 does not apply to bfloat16.  No matmul is on the
codecs' path, but bfloat16 matmuls are pinned to full-precision
reductions all the same, so one added later cannot take a split-K
reduction that rounds differently between calls.
"""

import torch as _torch

_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
_torch.backends.cudnn.deterministic = True
_torch.backends.cudnn.benchmark = False

del _torch
