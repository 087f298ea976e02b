"""Entropy models: QP-banked factorized prior + conditional Gaussian, as
builders of the quantized CDF tables (`cdf_info`).

Counterpart of the JAX package's `entropy/models.py`.  Tables are sampled
on the host in float64 numpy (deterministic across machines: encoder and
decoder must derive identical tables) and are equal to the JAX package's
for the same parameters.  `update()` returns the tables; given an
`EntropyCoder` it also registers them with the host coder, and the
`encode_*` / `decode_*` / `get_*` methods code through it (the host-EC
path).  The host coder takes planes flattened NHWC.

The differentiable rate terms of training (`bit_estimator_bits`,
`gaussian_bits`) take NCHW tensors and are computed in float32 whatever
the input's dtype, as the JAX package computes them (under a bfloat16
policy the CDF differences would cancel).
"""

import math

import numpy as np
import torch
import torch.nn.functional as TF
from scipy import special as sp_special

from .cdf import pmf_to_cdf


def bitparm_init(gen, qp_num, channel, final=False):
    p = {"h": 0.01 * torch.randn((qp_num, channel), generator=gen),
         "b": 0.01 * torch.randn((qp_num, channel), generator=gen)}
    if not final:
        p["a"] = 0.01 * torch.randn((qp_num, channel), generator=gen)
    return p


def bit_estimator_init(gen, qp_num, channel):
    return {"f1": bitparm_init(gen, qp_num, channel),
            "f2": bitparm_init(gen, qp_num, channel),
            "f3": bitparm_init(gen, qp_num, channel),
            "f4": bitparm_init(gen, qp_num, channel, final=True)}


def _bitparm_apply(p, x, qp):
    """One Bitparm layer on NCHW x with the bank row `qp` of (Q, C)
    params."""
    h = TF.softplus(p["h"][qp])[:, None, None]
    x = x * h + p["b"][qp][:, None, None]
    if "a" in p:
        x = x + torch.tanh(x) * torch.tanh(p["a"][qp])[:, None, None]
    return x


def bit_estimator_logits(params, x, qp):
    """The factorized prior's logits at x (NCHW) for the bank row qp."""
    for name in ("f1", "f2", "f3", "f4"):
        x = _bitparm_apply(params[name], x, qp)
    return x


def bit_estimator_cdf(params, x, qp):
    return torch.sigmoid(bit_estimator_logits(params, x, qp))


def bit_estimator_bits(params, z, qp):
    """Differentiable bits of z (NCHW) under the factorized prior:
    -log2(cdf(z + 0.5) - cdf(z - 0.5)), the difference clipped at 1e-9;
    z is taken in float32."""
    z = z.float()
    upper = bit_estimator_cdf(params, z + 0.5, qp)
    lower = bit_estimator_cdf(params, z - 0.5, qp)
    return -torch.log2(torch.clamp(upper - lower, min=1e-9))


_HALF_SQRT2 = float(np.float32(0.5) * np.sqrt(np.float32(2.0),
                                               dtype=np.float32))


def _ndtr(x):
    """The standard normal CDF in the form JAX's `ndtr` evaluates it: 1 +
    erf(w) near 0, 2 - erfc(|w|) above, erfc(|w|) below, halved.
    torch.special.ndtr is the same function but rounds differently next to
    1: there one ulp decides whether a tail probability difference is
    2^-24 or clipped to 1e-9, 24 or 29.9 bits (on the CPU, 2.4 % of
    symbols with random scales)."""
    w = x * _HALF_SQRT2
    z = w.abs()
    return 0.5 * torch.where(z < _HALF_SQRT2, 1.0 + torch.erf(w),
                             torch.where(w > 0, 2.0 - torch.erfc(z),
                                         torch.erfc(z)))


def gaussian_bits(y_res, scales):
    """Differentiable bits of y_res under N(0, scales), integrated over
    [y - 0.5, y + 0.5] (scales clipped at 0.11, the difference at 1e-9),
    in float32, as JAX's norm.cdf(y +- 0.5, 0, s) = ndtr((y +- 0.5) /
    s)."""
    scales = torch.clamp(scales.float(), min=0.11)
    y = y_res.float()
    upper = _ndtr((y + 0.5) / scales)
    lower = _ndtr((y - 0.5) / scales)
    return -torch.log2(torch.clamp(upper - lower, min=1e-9))


def _np_bitparm(p, x):
    """Host float64 Bitparm forward; p entries are (Q, C), x is (Q, C, L)."""
    h = np.log1p(np.exp(p["h"]))  # softplus
    x = x * h[:, :, None] + p["b"][:, :, None]
    if "a" in p:
        x = x + np.tanh(x) * np.tanh(p["a"][:, :, None])
    return x


def _np_cdf(params_np, x):
    for name in ("f1", "f2", "f3", "f4"):
        x = _np_bitparm(params_np[name], x)
    return 1.0 / (1.0 + np.exp(-x))


class BitEstimator:
    """CDF tables of the factorized prior over z, one row per (qp,
    channel).  support: half-width of the symbol-support scan (8 for the
    RT models)."""

    def __init__(self, qp_num, channel, support=8):
        self.qp_num = qp_num
        self.channel = channel
        self.support = support
        self.cdf_info = None
        self.entropy_coder = None
        self.cdf_group_index = None

    def update(self, params, entropy_coder=None):
        """Sample the learned CDF and quantize it: scan the support,
        evaluate the pmf at half-integer offsets.  params: the
        `bit_estimator_z` dict of tensors.  Returns `cdf_info`; with an
        entropy coder, also registers the rows (no decoder lookup
        table)."""
        p = {name: {k: v.detach().to("cpu", torch.float32).numpy()
                    .astype(np.float64) for k, v in layer.items()}
             for name, layer in params.items()}
        Q, C = self.qp_num, self.channel
        S = self.support

        def cdf_at(v):
            x = np.full((Q, C, 1), float(v), dtype=np.float64)
            return _np_cdf(p, x)[:, :, 0]

        minima = np.full((Q, C), S, dtype=np.int64)
        for i in range(S, 1, -1):
            probs = cdf_at(-i)
            minima = np.where(probs < 1e-4, i, minima)
        maxima = np.full((Q, C), S, dtype=np.int64)
        for i in range(S, 1, -1):
            probs = cdf_at(i)
            maxima = np.where(probs > 0.9999, i, maxima)

        offset = -minima
        pmf_start = -minima.astype(np.float64)
        pmf_length = maxima + minima + 1
        max_length = int(pmf_length.max())

        samples = np.arange(max_length, dtype=np.float64)[None, None, :] \
            + pmf_start[:, :, None]
        lower = _np_cdf(p, samples - 0.5)
        upper = _np_cdf(p, samples + 0.5)
        pmf = upper - lower

        cdf_at_max = _np_cdf(p, maxima.astype(np.float64)[:, :, None])[:, :, 0]
        tail_mass = lower[:, :, 0] + (1.0 - cdf_at_max)

        pmf = pmf.reshape(-1, max_length)
        tail_mass = tail_mass.reshape(-1, 1)
        pmf_length = pmf_length.reshape(-1)
        offset = offset.reshape(-1)
        quantized_cdf = pmf_to_cdf(pmf, tail_mass, pmf_length, max_length)
        cdf_length = pmf_length + 2
        self.cdf_info = (quantized_cdf, cdf_length.astype(np.int32),
                         offset.astype(np.int32))
        if entropy_coder is not None:
            self.entropy_coder = entropy_coder
            self.cdf_group_index = entropy_coder.add_cdf(*self.cdf_info,
                                                         build_lut=False)
        return self.cdf_info

    def encode_z(self, z_int8_flat, qp):
        """z: int8 numpy, flattened NHWC."""
        self.entropy_coder.encode_z(z_int8_flat, self.cdf_group_index,
                                    qp * self.channel, self.channel)

    def decode_z(self, size, qp):
        """Queues the decode of a (size[0], size[1]) z plane."""
        total = self.channel * size[0] * size[1]
        self.entropy_coder.decode_z(total, self.cdf_group_index,
                                    qp * self.channel, self.channel)

    def get_z(self, size, dtype=np.float32):
        """Waits for decode_z; returns the (1, H, W, C) NHWC plane."""
        val = self.entropy_coder.get_decoded_tensor()
        return val.reshape(1, size[0], size[1], self.channel).astype(dtype)


def _normal_cdf(x):
    return 0.5 * (1.0 + sp_special.erf(x / math.sqrt(2.0)))


def _laplace_cdf(x):
    """CDF of Laplace(0, b=1) at x (x pre-divided by the scale).  Both
    where-branches are evaluated, so the exponents are clamped."""
    return np.where(x < 0, 0.5 * np.exp(np.minimum(x, 0.0)),
                    1.0 - 0.5 * np.exp(np.minimum(-x, 0.0)))


class GaussianEncoder:
    """Zero-mean CDF tables over a log-spaced scale table.

    The defaults are the RT generation (gaussian, [0.11, 16], 128
    levels, whatever the distribution); the FM generation takes 256
    levels up to 64, and DMCFM a Laplace distribution over [0.01, 64].
    `support` bounds each scale's pmf width.  SCALE_MIN, SCALE_MAX,
    log_scale_min and log_step_recip are the constants the codecs build
    CDF indexes with."""

    SCALE_MIN = 0.11
    SCALE_MAX = 16.0
    SCALE_LEVELS = 128

    def __init__(self, distribution="gaussian", scale_min=SCALE_MIN,
                 scale_max=SCALE_MAX, scale_levels=SCALE_LEVELS, support=8):
        if distribution not in ("gaussian", "laplace"):
            raise ValueError(f"distribution {distribution!r}")
        self.distribution = distribution
        self.SCALE_MIN = scale_min
        self.SCALE_MAX = scale_max
        self.SCALE_LEVELS = scale_levels
        self.support = support
        self.log_scale_min = math.log(self.SCALE_MIN)
        self.log_scale_max = math.log(self.SCALE_MAX)
        self.log_scale_step = ((self.log_scale_max - self.log_scale_min)
                               / (self.SCALE_LEVELS - 1))
        self.log_step_recip = 1.0 / self.log_scale_step
        self.scale_table = np.exp(np.linspace(
            self.log_scale_min, self.log_scale_max, self.SCALE_LEVELS))
        self.cdf_info = None
        self.entropy_coder = None
        self.cdf_group_index = None
        self.force_zero_thres = None

    def _cdf(self, x):
        if self.distribution == "laplace":
            return _laplace_cdf(x)
        return _normal_cdf(x)

    def update(self, entropy_coder=None, force_zero_thres=None):
        """Returns `cdf_info`; with an entropy coder, also registers the
        rows (with the decoder's lookup table)."""
        self.force_zero_thres = force_zero_thres
        S = self.support
        scales = self.scale_table.astype(np.float64)
        pmf_center = np.full(self.SCALE_LEVELS, S, dtype=np.int64)
        for i in range(S, 1, -1):
            probs = self._cdf(i / scales)
            pmf_center = np.where(probs > 0.9999, i, pmf_center)

        pmf_length = 2 * pmf_center + 1
        max_length = int(pmf_length.max())
        samples = (np.arange(max_length, dtype=np.float64)[None, :]
                   - pmf_center[:, None])
        upper = self._cdf((samples + 0.5) / scales[:, None])
        lower = self._cdf((samples - 0.5) / scales[:, None])
        pmf = upper - lower
        tail_mass = 2 * lower[:, :1]

        quantized_cdf = pmf_to_cdf(pmf, tail_mass, pmf_length, max_length)
        self.cdf_info = (quantized_cdf,
                         (pmf_length + 2).astype(np.int32),
                         (-pmf_center).astype(np.int32))
        if entropy_coder is not None:
            self.entropy_coder = entropy_coder
            self.cdf_group_index = entropy_coder.add_cdf(*self.cdf_info,
                                                         build_lut=True)
        return self.cdf_info

    def encode_y_packed(self, packed, skip_cond=None):
        """packed: int16 numpy flattened NHWC; skip_cond (same order)
        keeps the coded positions."""
        packed = np.asarray(packed, dtype=np.int16).reshape(-1)
        if skip_cond is not None:
            packed = packed[np.asarray(skip_cond, dtype=bool).reshape(-1)]
        self.entropy_coder.encode_y(packed, self.cdf_group_index)

    def decode_y(self, indexes, skip_cond=None):
        """Queues the decode of the kept positions' symbols."""
        indexes = np.asarray(indexes, dtype=np.uint8).reshape(-1)
        if skip_cond is not None:
            indexes = indexes[np.asarray(skip_cond, dtype=bool).reshape(-1)]
        self.entropy_coder.decode_y(indexes, self.cdf_group_index)

    def get_y(self, shape, skip_cond=None, dtype=np.float32):
        """Waits for decode_y; scatters the symbols back into a dense
        plane of `shape`, zeros where skipped."""
        val = self.entropy_coder.get_decoded_tensor().astype(dtype)
        if skip_cond is None:
            return val.reshape(shape)
        keep = np.asarray(skip_cond, dtype=bool).reshape(-1)
        out = np.zeros(keep.shape[0], dtype=dtype)
        out[keep] = val
        return out.reshape(shape)
