"""The CompressAI-era image-codec zoo (DCVC's I-frame models), NCHW, host EC.

Counterpart of the JAX package's `models/priors_zoo.py`: FactorizedPrior,
ScaleHyperprior, MeanScaleHyperprior, JointAutoregressiveHierarchicalPriors
and Cheng2020Anchor at the JAX package's constructor defaults, and the
registry IMAGE_CODEC_ZOO.  5x5 stride-2 conv towers with GDN, 2x
transposed convs for synthesis (Cheng2020: residual blocks and subpel
upsampling); the y symbols are clipped to the int8 range; y is coded
against 64 Gaussian scale levels in [0.11, 256] (support 50), z (or, in
FactorizedPrior, y) against a single-bank factorized prior.  The two
autoregressive models code y through DCVC's masked-conv `_ARCoder` on the
host.

Each segment is a separate stream (the coder flushed and reset after
it); compress returns {"strings": [[y_string], [z_string]] (FactorizedPrior
[[y_string]]), "shape": (the coded factorized plane's H, W)}, and
decompress(strings, shape) {"x_hat": NHWC in [0, 1]}, as the JAX package
nests them.  The y CDF indexes are computed on the host in float32 numpy
from the scales read as float32, as the JAX package computes them.

Parameters stay as loaded (float32 from init, never cast); activations
run in `dtype` (float32 or bfloat16).
"""

import numpy as np
import torch

from ..entropy.coder import EntropyCoder
from ..entropy.models import (BitEstimator, GaussianEncoder,
                              bit_estimator_init)
from ..layers import blocks_evc as E
from ..layers import blocks_hem as H
from ..layers.blocks import conv_apply, conv_init, conv_transpose2x_apply
from ..layers.gdn import gdn_apply, gdn_init
from ..ops import fused as F
from ..ops.fused import depth_to_space
from ..utils.params import to_device
from ..utils.transfer import fetch_async
from . import common as C
from .dcvc import _ARCoder, from_host_hwc, host_hwc, masked_conv_init
from .dmci_fm import gaussian_cfg


def _ga_init(gen, N, M):
    return {"convs": [conv_init(gen, 3, N, 5),
                      conv_init(gen, N, N, 5),
                      conv_init(gen, N, N, 5),
                      conv_init(gen, N, M, 5)],
            "gdns": [gdn_init(gen, N) for _ in range(3)]}


def _ga_apply(p, x):
    h = x
    for i in range(4):
        h = conv_apply(p["convs"][i], h, stride=2, padding=2)
        if i < 3:
            h = gdn_apply(p["gdns"][i], h)
    return h


def _gs_init(gen, N, M):
    return {"convs": [conv_init(gen, M, N, 5),
                      conv_init(gen, N, N, 5),
                      conv_init(gen, N, N, 5),
                      conv_init(gen, N, 3, 5)],
            "gdns": [gdn_init(gen, N) for _ in range(3)]}


def _gs_apply(p, y):
    h = y
    for i in range(4):
        h = conv_transpose2x_apply(p["convs"][i], h, torch_padding=2)
        if i < 3:
            h = gdn_apply(p["gdns"][i], h, inverse=True)
    return h


def _host_f32(t):
    """A (1, C, H, W) plane on the host as float32 numpy (1, H, W, C)."""
    return fetch_async(t.permute(0, 2, 3, 1).float().contiguous())()


class _ZooBase:
    """Common orchestration: the factorized plane's coding and the
    Gaussian y coding."""

    def __init__(self, N, M, device="cuda", dtype=torch.float32):
        C.check_dtype(dtype, type(self).__name__)
        self.device = C.resolve_device(device)
        self.N, self.M = N, M
        self.dtype = dtype
        self.params = None
        self.entropy_coder = None
        self.gaussian_encoder = GaussianEncoder(
            distribution="gaussian", scale_min=0.11, scale_max=256.0,
            scale_levels=64, support=50)
        self._cfg = None

    def init_params(self, seed=0):
        """The port's random init (torch.Generator), not the JAX
        package's draws; nothing is cast."""
        gen = torch.Generator().manual_seed(seed)
        self.load_params(self._init(gen))
        return self.params

    def load_params(self, params):
        self.params = to_device(params, self.device)

    def update(self):
        """A new host coder with the Gaussian scale rows and the
        bottleneck's rows registered (groups 0 and 1)."""
        self.entropy_coder = EntropyCoder()
        self.gaussian_encoder.update(self.entropy_coder)
        self.bottleneck.update(self.params["bottleneck"], self.entropy_coder)
        self._cfg = gaussian_cfg(self.gaussian_encoder)

    def _x(self, x):
        return C.frame_to_nchw(x, self.device, self.dtype)

    def _segment(self):
        self.entropy_coder.flush()
        seg = self.entropy_coder.get_encoded_stream()
        self.entropy_coder.reset()
        return seg

    def _encode_factorized(self, q_int8):
        """q_int8: (1, C, H, W) int8 on the device."""
        self.entropy_coder.reset()
        self.bottleneck.encode_z(fetch_async(C.nhwc_flat(q_int8))(), 0)
        return self._segment()

    def _decode_factorized(self, shape_hw):
        """The factorized plane of shape_hw as (1, C, H, W) `dtype`."""
        self.bottleneck.decode_z(shape_hw, 0)
        return C.from_host_nhwc(self.bottleneck.get_z(shape_hw), self.device,
                                self.dtype)

    def _index(self, scales):
        """The CDF indexes of float32 numpy scales, in float32 numpy."""
        smin, smax, lsm, recip = self._cfg
        sc = np.clip(np.asarray(scales, np.float32), smin, smax)
        return ((np.log(sc) - lsm) * recip).astype(np.uint8)

    def _encode_gaussian(self, y_q, scales):
        """y_q, scales: float32 numpy (1, H, W, C)."""
        idx = self._index(scales)
        q = np.clip(np.asarray(y_q), -128, 127).astype(np.int16)
        packed = (q << 8) | idx.astype(np.int16)
        self.entropy_coder.reset()
        self.gaussian_encoder.encode_y_packed(packed.reshape(-1))
        return self._segment()

    def _decode_gaussian(self, scales):
        """scales: float32 numpy (1, H, W, C); returns the symbols as
        float32 numpy of that shape."""
        idx = self._index(scales)
        self.gaussian_encoder.decode_y(idx.reshape(-1))
        return self.gaussian_encoder.get_y(idx.shape)

    def _gs(self, y_hat):
        """The synthesis transform, clipped to [0, 1]."""
        return torch.clamp(self._fwd_gs(self.params, y_hat), 0.0, 1.0)

    @staticmethod
    def _fwd_gs(p, y):
        return _gs_apply(p["g_s"], y)


class FactorizedPrior(_ZooBase):
    def __init__(self, N=128, M=192, device="cuda", dtype=torch.float32):
        super().__init__(N, M, device, dtype)
        self.bottleneck = BitEstimator(1, M, support=50)

    def _init(self, gen):
        return {"g_a": _ga_init(gen, self.N, self.M),
                "g_s": _gs_init(gen, self.N, self.M),
                "bottleneck": bit_estimator_init(gen, 1, self.M)}

    def compress(self, x):
        y = _ga_apply(self.params["g_a"], self._x(x))
        _, y_int8 = F.round_and_to_int8(y)
        y_string = self._encode_factorized(y_int8)
        return {"strings": [[y_string]], "shape": (y.shape[2], y.shape[3])}

    def decompress(self, strings, shape):
        self.entropy_coder.set_stream(strings[0][0])
        y_hat = self._decode_factorized(shape)
        self.entropy_coder.check_stream_end()
        return {"x_hat": C.frame_to_nhwc(self._gs(y_hat))}


class ScaleHyperprior(_ZooBase):
    mean_scale = False

    def __init__(self, N=128, M=192, device="cuda", dtype=torch.float32):
        super().__init__(N, M, device, dtype)
        self.bottleneck = BitEstimator(1, N, support=50)

    @staticmethod
    def _fwd_ga(p, x):
        y = _ga_apply(p["g_a"], x)
        h = torch.relu(conv_apply(p["h_a"][0], torch.abs(y), padding=1))
        h = torch.relu(conv_apply(p["h_a"][1], h, stride=2, padding=2))
        z = conv_apply(p["h_a"][2], h, stride=2, padding=2)
        return y, z

    @staticmethod
    def _fwd_hs(p, z_hat):
        h = torch.relu(conv_transpose2x_apply(p["h_s"][0], z_hat,
                                              torch_padding=2))
        h = torch.relu(conv_transpose2x_apply(p["h_s"][1], h,
                                              torch_padding=2))
        return torch.relu(conv_apply(p["h_s"][2], h, padding=1))

    def _init(self, gen):
        N, M = self.N, self.M
        return {
            "g_a": _ga_init(gen, N, M),
            "g_s": _gs_init(gen, N, M),
            "h_a": [conv_init(gen, M, N, 3), conv_init(gen, N, N, 5),
                    conv_init(gen, N, N, 5)],
            "h_s": [conv_init(gen, N, N, 5), conv_init(gen, N, N, 5),
                    conv_init(gen, N, M, 3)],
            "bottleneck": bit_estimator_init(gen, 1, N),
        }

    def _z_hat(self, z_int8):
        return z_int8.to(torch.float32).to(self.dtype)

    def compress(self, x):
        y, z = self._fwd_ga(self.params, self._x(x))
        _, z_int8 = F.round_and_to_int8(z)
        z_string = self._encode_factorized(z_int8)
        scales = self._fwd_hs(self.params, self._z_hat(z_int8))
        y_q = np.round(_host_f32(y))
        y_string = self._encode_gaussian(y_q, _host_f32(scales))
        return {"strings": [[y_string], [z_string]],
                "shape": (z.shape[2], z.shape[3])}

    def decompress(self, strings, shape):
        self.entropy_coder.set_stream(strings[1][0])
        z_hat = self._decode_factorized(shape)
        self.entropy_coder.check_stream_end()
        scales = self._fwd_hs(self.params, z_hat)
        self.entropy_coder.set_stream(strings[0][0])
        y_q = self._decode_gaussian(_host_f32(scales))
        self.entropy_coder.check_stream_end()
        y_hat = C.from_host_nhwc(y_q, self.device, self.dtype)
        return {"x_hat": C.frame_to_nhwc(self._gs(y_hat))}


class MeanScaleHyperprior(ScaleHyperprior):
    mean_scale = True

    @staticmethod
    def _fwd_ga(p, x):
        y = _ga_apply(p["g_a"], x)
        h = E.lrelu(conv_apply(p["h_a"][0], y, padding=1), 0.01)
        h = E.lrelu(conv_apply(p["h_a"][1], h, stride=2, padding=2), 0.01)
        z = conv_apply(p["h_a"][2], h, stride=2, padding=2)
        return y, z

    @staticmethod
    def _fwd_hs(p, z_hat):
        h = E.lrelu(conv_transpose2x_apply(p["h_s"][0], z_hat,
                                           torch_padding=2), 0.01)
        h = E.lrelu(conv_transpose2x_apply(p["h_s"][1], h,
                                           torch_padding=2), 0.01)
        return conv_apply(p["h_s"][2], h, padding=1)

    def _init(self, gen):
        N, M = self.N, self.M
        return {
            "g_a": _ga_init(gen, N, M),
            "g_s": _gs_init(gen, N, M),
            "h_a": [conv_init(gen, M, N, 3), conv_init(gen, N, N, 5),
                    conv_init(gen, N, N, 5)],
            "h_s": [conv_init(gen, N, M, 5),
                    conv_init(gen, M, M * 3 // 2, 5),
                    conv_init(gen, M * 3 // 2, M * 2, 3)],
            "bottleneck": bit_estimator_init(gen, 1, N),
        }

    def _scales_means(self, z_hat):
        """The hyper synthesis' halves on the host, float32 (1, H, W, C)."""
        gp = _host_f32(self._fwd_hs(self.params, z_hat))
        c = gp.shape[-1] // 2
        return gp[..., :c], gp[..., c:]

    def compress(self, x):
        y, z = self._fwd_ga(self.params, self._x(x))
        _, z_int8 = F.round_and_to_int8(z)
        z_string = self._encode_factorized(z_int8)
        scales, means = self._scales_means(self._z_hat(z_int8))
        y_q = np.round(_host_f32(y) - means)
        y_string = self._encode_gaussian(y_q, scales)
        return {"strings": [[y_string], [z_string]],
                "shape": (z.shape[2], z.shape[3])}

    def decompress(self, strings, shape):
        self.entropy_coder.set_stream(strings[1][0])
        z_hat = self._decode_factorized(shape)
        self.entropy_coder.check_stream_end()
        scales, means = self._scales_means(z_hat)
        self.entropy_coder.set_stream(strings[0][0])
        y_q = self._decode_gaussian(scales)
        self.entropy_coder.check_stream_end()
        y_hat = C.from_host_nhwc(y_q + means, self.device, self.dtype)
        return {"x_hat": C.frame_to_nhwc(self._gs(y_hat))}


class JointAutoregressiveHierarchicalPriors(_ZooBase):
    """Joint hierarchical + autoregressive priors; the autoregressive loop
    runs on the host (`_ARCoder`)."""

    def __init__(self, N=192, M=192, device="cuda", dtype=torch.float32):
        super().__init__(N, M, device, dtype)
        self.bottleneck = BitEstimator(1, N, support=50)
        self._ar = None

    @staticmethod
    def _ga_tower(p, x):
        return _ga_apply(p["g_a"], x)

    @staticmethod
    def _gs_tower(p, y):
        return _gs_apply(p["g_s"], y)

    @classmethod
    def _fwd_ga(cls, p, x):
        y = cls._ga_tower(p, x)
        h = E.lrelu(conv_apply(p["h_a"][0], y, padding=1), 0.01)
        h = E.lrelu(conv_apply(p["h_a"][1], h, stride=2, padding=2), 0.01)
        z = conv_apply(p["h_a"][2], h, stride=2, padding=2)
        return y, z

    @classmethod
    def _fwd_hs(cls, p, z_hat):
        h = E.lrelu(conv_transpose2x_apply(p["h_s"][0], z_hat,
                                           torch_padding=2), 0.01)
        h = E.lrelu(conv_transpose2x_apply(p["h_s"][1], h,
                                           torch_padding=2), 0.01)
        return conv_apply(p["h_s"][2], h, padding=1)

    @classmethod
    def _fwd_gs(cls, p, y):
        return cls._gs_tower(p, y)

    def _init(self, gen):
        N, M = self.N, self.M
        return {
            "g_a": _ga_init(gen, N, M),
            "g_s": _gs_init(gen, N, M),
            "h_a": [conv_init(gen, M, N, 3), conv_init(gen, N, N, 5),
                    conv_init(gen, N, N, 5)],
            "h_s": [conv_init(gen, N, M, 5),
                    conv_init(gen, M, M * 3 // 2, 5),
                    conv_init(gen, M * 3 // 2, M * 2, 3)],
            "entropy_parameters": [
                conv_init(gen, M * 4, M * 10 // 3, 1),
                conv_init(gen, M * 10 // 3, M * 8 // 3, 1),
                conv_init(gen, M * 8 // 3, M * 2, 1)],
            "context_prediction": masked_conv_init(gen, M, M * 2),
            "bottleneck": bit_estimator_init(gen, 1, N),
        }

    def update(self):
        super().update()
        self._ar = _ARCoder(self.params, "context_prediction",
                            "entropy_parameters")

    def compress(self, x):
        y, z = self._fwd_ga(self.params, self._x(x))
        _, z_int8 = F.round_and_to_int8(z)
        z_string = self._encode_factorized(z_int8)
        prior = self._fwd_hs(self.params, z_int8.to(torch.float32)
                             .to(self.dtype))
        y_fetch, prior_fetch = host_hwc(y), host_hwc(prior)
        self.entropy_coder.reset()
        self._ar.encode(y_fetch(), prior_fetch(), self.gaussian_encoder)
        y_string = self._segment()
        return {"strings": [[y_string], [z_string]],
                "shape": (z.shape[2], z.shape[3])}

    def decompress(self, strings, shape):
        self.entropy_coder.set_stream(strings[1][0])
        z_hat = self._decode_factorized(shape)
        self.entropy_coder.check_stream_end()
        prior = host_hwc(self._fwd_hs(self.params, z_hat))()
        self.entropy_coder.set_stream(strings[0][0])
        y_hat = from_host_hwc(self._ar.decode(prior, self.gaussian_encoder),
                              self.device, self.dtype)
        self.entropy_coder.check_stream_end()
        return {"x_hat": C.frame_to_nhwc(self._gs(y_hat))}


class Cheng2020Anchor(JointAutoregressiveHierarchicalPriors):
    """Residual-block towers and subpel upsampling."""

    def __init__(self, N=192, device="cuda", dtype=torch.float32):
        super().__init__(N=N, M=N, device=device, dtype=dtype)

    @staticmethod
    def _ga_tower(p, x):
        g = p["g_a"]
        h = E.res_block_stride_apply(g["rbs1"], x)
        h = H.residual_block_apply(g["rb1"], h)
        h = E.res_block_stride_apply(g["rbs2"], h)
        h = H.residual_block_apply(g["rb2"], h)
        h = E.res_block_stride_apply(g["rbs3"], h)
        h = H.residual_block_apply(g["rb3"], h)
        return conv_apply(g["down"], h, stride=2, padding=1)

    @staticmethod
    def _gs_tower(p, y):
        g = p["g_s"]
        h = H.residual_block_apply(g["rb1"], y)
        h = E.res_block_upsample_apply(g["rbu1"], h)
        h = H.residual_block_apply(g["rb2"], h)
        h = E.res_block_upsample_apply(g["rbu2"], h)
        h = H.residual_block_apply(g["rb3"], h)
        h = E.res_block_upsample_apply(g["rbu3"], h)
        h = H.residual_block_apply(g["rb4"], h)
        return depth_to_space(conv_apply(g["subpel"], h, padding=1), 2)

    @classmethod
    def _fwd_ga(cls, p, x):
        y = cls._ga_tower(p, x)
        h = E.lrelu(conv_apply(p["h_a"][0], y, padding=1), 0.01)
        h = E.lrelu(conv_apply(p["h_a"][1], h, padding=1), 0.01)
        h = E.lrelu(conv_apply(p["h_a"][2], h, stride=2, padding=1), 0.01)
        h = E.lrelu(conv_apply(p["h_a"][3], h, padding=1), 0.01)
        z = conv_apply(p["h_a"][4], h, stride=2, padding=1)
        return y, z

    @classmethod
    def _fwd_hs(cls, p, z_hat):
        h = E.lrelu(conv_apply(p["h_s"][0], z_hat, padding=1), 0.01)
        h = E.lrelu(depth_to_space(conv_apply(p["h_s"][1], h, padding=1),
                                   2), 0.01)
        h = E.lrelu(conv_apply(p["h_s"][2], h, padding=1), 0.01)
        h = E.lrelu(depth_to_space(conv_apply(p["h_s"][3], h, padding=1),
                                   2), 0.01)
        return conv_apply(p["h_s"][4], h, padding=1)

    def _init(self, gen):
        N = self.N
        return {
            "g_a": {
                "rbs1": E.res_block_stride_init(gen, 3, N),
                "rb1": H.residual_block_init(gen, N, N),
                "rbs2": E.res_block_stride_init(gen, N, N),
                "rb2": H.residual_block_init(gen, N, N),
                "rbs3": E.res_block_stride_init(gen, N, N),
                "rb3": H.residual_block_init(gen, N, N),
                "down": conv_init(gen, N, N, 3),
            },
            "g_s": {
                "rb1": H.residual_block_init(gen, N, N),
                "rbu1": E.res_block_upsample_init(gen, N, N),
                "rb2": H.residual_block_init(gen, N, N),
                "rbu2": E.res_block_upsample_init(gen, N, N),
                "rb3": H.residual_block_init(gen, N, N),
                "rbu3": E.res_block_upsample_init(gen, N, N),
                "rb4": H.residual_block_init(gen, N, N),
                "subpel": conv_init(gen, N, 3 * 4, 3),
            },
            "h_a": [conv_init(gen, N, N, 3) for _ in range(5)],
            "h_s": [conv_init(gen, N, N, 3),
                    conv_init(gen, N, N * 4, 3),
                    conv_init(gen, N, N * 3 // 2, 3),
                    conv_init(gen, N * 3 // 2, N * 3 // 2 * 4, 3),
                    conv_init(gen, N * 3 // 2, N * 2, 3)],
            "entropy_parameters": [
                conv_init(gen, N * 4, N * 10 // 3, 1),
                conv_init(gen, N * 10 // 3, N * 8 // 3, 1),
                conv_init(gen, N * 8 // 3, N * 2, 1)],
            "context_prediction": masked_conv_init(gen, N, N * 2),
            "bottleneck": bit_estimator_init(gen, 1, N),
        }


# the registry (reference: DCVC's zoo/image.py)
IMAGE_CODEC_ZOO = {
    "bmshj2018-factorized": FactorizedPrior,
    "bmshj2018-hyperprior": ScaleHyperprior,
    "mbt2018-mean": MeanScaleHyperprior,
    "mbt2018": JointAutoregressiveHierarchicalPriors,
    "cheng2020-anchor": Cheng2020Anchor,
}
