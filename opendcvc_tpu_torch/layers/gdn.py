"""GDN (generalized divisive normalization) and its LowerBound (NCHW).

Counterpart of the JAX package's `layers/gdn.py`: beta and gamma are
stored reparametrized (square roots with a pedestal) and bounded below by
a LowerBound whose gradient passes where the input is at or above the
bound, or where the gradient would push it back up.  gamma is a (C_out,
C_in) matrix, a 2-D leaf (not a conv `w`), so `utils/params.py` carries a
JAX tree's gamma across unchanged.
"""

import torch
import torch.nn.functional as F

_REPARAM_OFFSET = 2 ** -18
_PEDESTAL = _REPARAM_OFFSET ** 2


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x, bound):
    """max(x, bound), with the JAX package's straight-through gradient:
    g where x >= bound or g < 0, else 0."""
    return _LowerBound.apply(x, bound)


def gdn_init(gen, ch, gamma_init=0.1):
    """beta = sqrt(1 + pedestal), gamma = sqrt(gamma_init * I + pedestal),
    float32; nothing is drawn (`gen` is taken for the init functions'
    common signature)."""
    del gen
    beta = torch.sqrt(torch.ones(ch) + _PEDESTAL)
    gamma = torch.sqrt(gamma_init * torch.eye(ch) + _PEDESTAL)
    return {"beta": beta, "gamma": gamma}


def gdn_apply(p, x, inverse=False, beta_min=1e-6):
    """x: NCHW.  norm = gamma . x^2 + beta over the channels, in float32
    (JAX's HIGHEST-precision einsum; the port keeps TF32 off), its sqrt
    cast to x's dtype; y = x / sqrt(norm), or x * sqrt(norm) for the
    inverse (IGDN)."""
    beta_bound = (beta_min + _PEDESTAL) ** 0.5
    beta = lower_bound(p["beta"], beta_bound) ** 2 - _PEDESTAL
    gamma = lower_bound(p["gamma"], _REPARAM_OFFSET) ** 2 - _PEDESTAL
    # "bhwc,oc->bhwo" of the JAX package: out[o] = sum_c gamma[o, c] x2[c]
    norm = F.conv2d((x * x).float(), gamma.float()[:, :, None, None])
    norm = norm + beta.float()[:, None, None]
    norm = torch.sqrt(norm).to(x.dtype)
    return x * norm if inverse else x / norm
