"""DCVC — the original conditional-coding video codec (NCHW), host EC.

Counterpart of the JAX package's `models/dcvc.py`: HEM's SpyNet, GDN
motion and contextual towers, feature-domain motion compensation with a
context-refine net, factorized priors for z and the motion z (64
channels each, support 50), and the 5x5 masked-convolution
autoregressive entropy model of y (96 channels at 1/16) and the motion
latent (128 channels), whose residuals are coded against 256 Laplace
scale levels in [0.01, 64].

The autoregressive loop is serial: each latent pixel's distribution
depends on the pixels decoded before it.  The device runs every dense
stage; the loop (`_ARCoder`) runs on the host in float64 numpy, the same
code on both sides, so it is bit-exact by construction.  Each plane and
its prior cross to the host once, as float32 read into float64; the
decoded latent crosses back once, cast to the codec's dtype.  The four
segments (mv_z, mv_y, z, y) are separate streams, each flushed and the
coder reset after it, as the JAX package codes them.

The causal mask of a masked convolution is a fixed leaf of the parameter
tree, "mask", stored (k, k, 1, 1) as the JAX package stores it: it takes
no gradient (the training step of `training/train.py` leaves every
"mask" leaf out).

Parameters stay as loaded (float32 from init, never cast, as in the JAX
package); activations run in `dtype` (float32 or bfloat16), each
convolution casting its weights to its input's dtype.  The reference
frame is cast to the codec's dtype on both sides.
"""

import numpy as np
import torch

from ..entropy.coder import EntropyCoder
from ..entropy.models import (BitEstimator, GaussianEncoder,
                              bit_estimator_init)
from ..layers.blocks import conv_apply, conv_init, conv_transpose2x_apply
from ..layers.blocks_evc import lrelu
from ..layers.blocks_hem import hem_spynet_apply as spynet_apply
from ..layers.blocks_hem import hem_spynet_init as spynet_init
from ..layers.gdn import gdn_apply, gdn_init
from ..ops import fused as F
from ..ops.fused import depth_to_space
from ..ops.warp import flow_warp
from ..utils.params import to_device
from ..utils.transfer import fetch_async
from . import common as C

CH_MV = 128
CH_N = 64
CH_M = 96


def masked_conv_init(gen, in_ch, out_ch, k=5):
    """A conv with a type-A causal mask: zero at and after the centre in
    raster order.  The mask is (k, k, 1, 1), the JAX package's layout."""
    p = conv_init(gen, in_ch, out_ch, k)
    mask = torch.ones((k, k, 1, 1))
    mask[k // 2, k // 2:] = 0
    mask[k // 2 + 1:] = 0
    p["mask"] = mask
    return p


def masked_conv_apply(p, x):
    """w x mask in w's dtype (the mask detached: it is not trained), then
    conv_apply with 'same' padding."""
    mask = p["mask"].detach().permute(2, 3, 0, 1).to(p["w"].dtype)
    return conv_apply({"w": p["w"] * mask, "b": p["b"]}, x,
                      padding=p["w"].shape[-1] // 2)


def _res_init(gen, in_ch, out_ch):
    p = {"c1": conv_init(gen, in_ch, out_ch, 3),
         "c2": conv_init(gen, out_ch, out_ch, 3)}
    if in_ch != out_ch:
        p["adapt"] = conv_init(gen, in_ch, out_ch, 1)
    return p


def _res_apply(p, x):
    """The pre-activation ReLU ResBlock."""
    h = torch.relu(x)
    h = conv_apply(p["c1"], h, padding=1)
    h = torch.relu(h)
    h = conv_apply(p["c2"], h, padding=1)
    identity = conv_apply(p["adapt"], x) if "adapt" in p else x
    return identity + h


def _res01_init(gen, ch):
    return {"c1": conv_init(gen, ch, ch, 3), "c2": conv_init(gen, ch, ch, 3)}


def _res01_apply(p, x):
    h = lrelu(conv_apply(p["c1"], x, padding=1), 0.1)
    h = lrelu(conv_apply(p["c2"], h, padding=1), 0.1)
    return x + h


def dcvc_init(gen):
    """The JAX package's tree (its keys in its order)."""
    p = {}
    p["optic_flow"] = spynet_init(gen)
    p["feature_extract"] = {
        "c": conv_init(gen, 3, CH_N, 3),
        "res": _res_init(gen, CH_N, CH_N),
    }
    p["context_refine"] = {
        "res": _res_init(gen, CH_N, CH_N),
        "c": conv_init(gen, CH_N, CH_N, 3),
    }
    p["mv_enc"] = {
        "convs": [conv_init(gen, 2 if i == 0 else CH_MV, CH_MV, 3)
                  for i in range(4)],
        "gdns": [gdn_init(gen, CH_MV) for _ in range(3)],
    }
    p["mv_dec1"] = {
        "convs": [conv_init(gen, CH_MV, CH_MV, 3) for _ in range(3)]
        + [conv_init(gen, CH_MV, 2, 3)],
        "gdns": [gdn_init(gen, CH_MV) for _ in range(3)],
    }
    p["mv_dec2"] = [conv_init(gen, 5 if i == 0 else 64, 2 if i == 6 else 64,
                              3) for i in range(7)]
    p["ctx_enc"] = {
        "convs": [conv_init(gen, CH_N + 3, CH_N, 5),
                  conv_init(gen, CH_N, CH_N, 5),
                  conv_init(gen, CH_N, CH_N, 5),
                  conv_init(gen, CH_N, CH_M, 5)],
        "gdns": [gdn_init(gen, CH_N) for _ in range(3)],
        "res": [_res01_init(gen, CH_N), _res01_init(gen, CH_N)],
    }
    p["ctx_dec1"] = {
        "subpels": [conv_init(gen, CH_M, CH_N * 4, 3)]
        + [conv_init(gen, CH_N, CH_N * 4, 3) for _ in range(3)],
        "gdns": [gdn_init(gen, CH_N) for _ in range(3)],
        "res": [_res01_init(gen, CH_N), _res01_init(gen, CH_N)],
    }
    p["ctx_dec2"] = {
        "c1": conv_init(gen, CH_N * 2, CH_N, 3),
        "res1": _res_init(gen, CH_N, CH_N),
        "res2": _res_init(gen, CH_N, CH_N),
        "c2": conv_init(gen, CH_N, 3, 3),
    }
    p["prior_enc"] = [conv_init(gen, CH_M, CH_N, 3),
                      conv_init(gen, CH_N, CH_N, 5),
                      conv_init(gen, CH_N, CH_N, 5)]
    p["prior_dec"] = [conv_init(gen, CH_N, CH_M, 5),
                      conv_init(gen, CH_M, CH_M, 5),
                      conv_init(gen, CH_M, CH_M, 3)]
    p["mv_prior_enc"] = [conv_init(gen, CH_MV, CH_N, 3),
                         conv_init(gen, CH_N, CH_N, 5),
                         conv_init(gen, CH_N, CH_N, 5)]
    p["mv_prior_dec"] = [conv_init(gen, CH_N, CH_N, 5),
                         conv_init(gen, CH_N, CH_N * 3 // 2, 5),
                         conv_init(gen, CH_N * 3 // 2, CH_MV * 2, 3)]
    p["entropy_parameters"] = [
        conv_init(gen, CH_M * 4, CH_M * 10 // 3, 1),
        conv_init(gen, CH_M * 10 // 3, CH_M * 8 // 3, 1),
        conv_init(gen, CH_M * 8 // 3, CH_M * 2, 1)]
    p["entropy_parameters_mv"] = [
        conv_init(gen, CH_MV * 4, CH_MV * 10 // 3, 1),
        conv_init(gen, CH_MV * 10 // 3, CH_MV * 8 // 3, 1),
        conv_init(gen, CH_MV * 8 // 3, CH_MV * 2, 1)]
    p["auto_regressive"] = masked_conv_init(gen, CH_M, CH_M * 2)
    p["auto_regressive_mv"] = masked_conv_init(gen, CH_MV, CH_MV * 2)
    p["temporal_prior_enc"] = {
        "convs": [conv_init(gen, CH_N, CH_N, 5),
                  conv_init(gen, CH_N, CH_N, 5),
                  conv_init(gen, CH_N, CH_N, 5),
                  conv_init(gen, CH_N, CH_M, 5)],
        "gdns": [gdn_init(gen, CH_N) for _ in range(3)],
    }
    p["bit_estimator_z"] = bit_estimator_init(gen, 1, CH_N)
    p["bit_estimator_z_mv"] = bit_estimator_init(gen, 1, CH_N)
    return p


# ---------------------------------------------------------------------------
# sub-networks
# ---------------------------------------------------------------------------

def mv_encoder(p, mv):
    e = p["mv_enc"]
    h = mv
    for i in range(4):
        h = conv_apply(e["convs"][i], h, stride=2, padding=1)
        if i < 3:
            h = gdn_apply(e["gdns"][i], h)
    return h


def mv_decoder_part1(p, mv_y_hat):
    d = p["mv_dec1"]
    h = mv_y_hat
    for i in range(3):
        h = conv_transpose2x_apply(d["convs"][i], h)
        h = gdn_apply(d["gdns"][i], h, inverse=True)
    return conv_transpose2x_apply(d["convs"][3], h)


def mv_refine(p, ref, mv):
    h = torch.cat((mv, ref), dim=1)
    for i, cp in enumerate(p["mv_dec2"]):
        h = conv_apply(cp, h, padding=1)
        if i != 6:
            h = lrelu(h, 0.1)
    return h + mv


def motion_compensation(p, ref, mv):
    feat = conv_apply(p["feature_extract"]["c"], ref, padding=1)
    feat = _res_apply(p["feature_extract"]["res"], feat)
    pred = flow_warp(feat, mv)
    ctx = _res_apply(p["context_refine"]["res"], pred)
    return conv_apply(p["context_refine"]["c"], ctx, padding=1)


def contextual_encoder(p, x, ctx):
    e = p["ctx_enc"]
    h = torch.cat((x, ctx), dim=1)
    h = gdn_apply(e["gdns"][0], conv_apply(e["convs"][0], h, stride=2,
                                           padding=2))
    h = _res01_apply(e["res"][0], h)
    h = gdn_apply(e["gdns"][1], conv_apply(e["convs"][1], h, stride=2,
                                           padding=2))
    h = _res01_apply(e["res"][1], h)
    h = gdn_apply(e["gdns"][2], conv_apply(e["convs"][2], h, stride=2,
                                           padding=2))
    return conv_apply(e["convs"][3], h, stride=2, padding=2)


def contextual_decoder(p, y_hat, ctx):
    d = p["ctx_dec1"]
    h = depth_to_space(conv_apply(d["subpels"][0], y_hat, padding=1), 2)
    h = gdn_apply(d["gdns"][0], h, inverse=True)
    h = depth_to_space(conv_apply(d["subpels"][1], h, padding=1), 2)
    h = gdn_apply(d["gdns"][1], h, inverse=True)
    h = _res01_apply(d["res"][0], h)
    h = depth_to_space(conv_apply(d["subpels"][2], h, padding=1), 2)
    h = gdn_apply(d["gdns"][2], h, inverse=True)
    h = _res01_apply(d["res"][1], h)
    h = depth_to_space(conv_apply(d["subpels"][3], h, padding=1), 2)

    d2 = p["ctx_dec2"]
    out = conv_apply(d2["c1"], torch.cat((h, ctx), dim=1), padding=1)
    out = _res_apply(d2["res1"], out)
    out = _res_apply(d2["res2"], out)
    return conv_apply(d2["c2"], out, padding=1)


def prior_enc(plist, y):
    h = lrelu(conv_apply(plist[0], y, padding=1), 0.01)
    h = lrelu(conv_apply(plist[1], h, stride=2, padding=2), 0.01)
    return conv_apply(plist[2], h, stride=2, padding=2)


def prior_dec(plist, z, last_pad=1):
    h = lrelu(conv_transpose2x_apply(plist[0], z, torch_padding=2), 0.01)
    h = lrelu(conv_transpose2x_apply(plist[1], h, torch_padding=2), 0.01)
    return conv_apply(plist[2], h, padding=last_pad)


def temporal_prior_enc(p, ctx):
    t = p["temporal_prior_enc"]
    h = ctx
    for i in range(4):
        h = conv_apply(t["convs"][i], h, stride=2, padding=2)
        if i < 3:
            h = gdn_apply(t["gdns"][i], h)
    return h


def entropy_params_apply(plist, x):
    h = lrelu(conv_apply(plist[0], x), 0.01)
    h = lrelu(conv_apply(plist[1], h), 0.01)
    return conv_apply(plist[2], h)


# ---------------------------------------------------------------------------
# stages (the dense device work; shared = evaluated by both sides)
# ---------------------------------------------------------------------------

def _stage_mv_front(p, x, ref):
    """Encoder-only: flow -> motion latent, rounded motion z."""
    est_mv = spynet_apply(p["optic_flow"], x, ref)
    mv_y = mv_encoder(p, est_mv)
    mv_z = prior_enc(p["mv_prior_enc"], mv_y)
    mv_z_hat, mv_z_int8 = F.round_and_to_int8(mv_z)
    return mv_y, mv_z_hat.to(x.dtype), mv_z_int8


def _stage_mv_prior_params(p, mv_z_hat):
    """Shared: motion z -> the motion latent's hyperprior."""
    return prior_dec(p["mv_prior_dec"], mv_z_hat)


def _stage_after_mv(p, ref, mv_y_hat):
    """Shared: motion latent -> the motion-compensated context."""
    mv_up = mv_decoder_part1(p, mv_y_hat)
    mv_ref = mv_refine(p, ref, mv_up)
    return motion_compensation(p, ref, mv_ref)


def _stage_ctx_front(p, x, ctx):
    """Encoder-only: frame + context -> y, rounded z."""
    y = contextual_encoder(p, x, ctx)
    z = prior_enc(p["prior_enc"], y)
    z_hat, z_int8 = F.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


def _stage_temporal(p, ctx):
    """Shared: the temporal prior of the context."""
    return temporal_prior_enc(p, ctx)


def _stage_y_prior_params(p, z_hat, temporal):
    """Shared: (temporal prior, z's hyperprior) -> y's prior."""
    hp = prior_dec(p["prior_dec"], z_hat)
    return torch.cat((temporal, hp), dim=1)


def _stage_recon(p, y_hat, ctx):
    """Shared: y_hat + context -> the frame in [0, 1]."""
    return torch.clamp(contextual_decoder(p, y_hat, ctx), 0.0, 1.0)


# ---------------------------------------------------------------------------
# the host-side autoregressive coder (float64 numpy, shared by both sides)
# ---------------------------------------------------------------------------

def _f64(t):
    """A tensor leaf as a float64 numpy array on the host."""
    return t.detach().to("cpu", torch.float32).numpy().astype(np.float64)


class _ARCoder:
    """The per-pixel masked-conv autoregressive entropy model on the host:
    the JAX package's `_ARCoder`, the same float64 arithmetic on the
    weights in the JAX package's layout, from the port's tree (moved to
    the host once)."""

    def __init__(self, params, ar_key, ep_key):
        ar = params[ar_key]
        # (Cout, Cin, k, k) -> (k, k, Cin, Cout), contiguous
        w = np.ascontiguousarray(_f64(ar["w"]).transpose(2, 3, 1, 0))
        self.w = w * _f64(ar["mask"])  # (5,5,Cin,Cout)
        self.b = _f64(ar["b"])
        # 1x1 convs -> matmuls over (Cin, Cout), contiguous
        self.ep = [(np.ascontiguousarray(_f64(c["w"])[:, :, 0, 0].T),
                    _f64(c["b"])) for c in params[ep_key]]
        self.cin = self.w.shape[2]

    def _ctx_at(self, y_pad, h, w):
        window = y_pad[h:h + 5, w:w + 5, :]  # (5,5,C)
        return np.einsum("klc,klco->o", window, self.w) + self.b

    def _entropy_params(self, prior_vec, ctx_vec):
        h = np.concatenate((prior_vec, ctx_vec))
        for i, (w, b) in enumerate(self.ep):
            h = h @ w + b
            if i != len(self.ep) - 1:
                h = np.where(h >= 0, h, 0.01 * h)
        c = h.shape[0] // 2
        return h[:c], h[c:]  # means, scales

    def encode(self, y, prior, gaussian_encoder):
        """y, prior: (H, W, C) numpy.  Codes the plane's packed symbols in
        one write; returns y_hat (H, W, C) float64.  `last_floats` keeps
        the plane's pre-rounding residuals and CDF index floats, for
        `eval/fm_ties.py`."""
        hgt, wid, c = y.shape
        y = np.asarray(y, np.float64)
        prior = np.asarray(prior, np.float64)
        y_pad = np.zeros((hgt + 4, wid + 4, c))
        y_pad[2:-2, 2:-2] = y
        y_q = np.zeros((hgt, wid, c))
        y_res = np.zeros((hgt, wid, c))
        y_scales = np.zeros((hgt, wid, c))
        for h in range(hgt):
            for w in range(wid):
                ctx = self._ctx_at(y_pad, h, w)
                means, scales = self._entropy_params(prior[h, w], ctx)
                y_res[h, w] = y[h, w] - means
                q = np.round(y_res[h, w])
                y_pad[h + 2, w + 2] = q + means
                y_q[h, w] = q
                y_scales[h, w] = scales
        smin = gaussian_encoder.SCALE_MIN
        smax = gaussian_encoder.SCALE_MAX
        sc = np.clip(y_scales, smin, smax)
        idx_f = (np.log(sc) - gaussian_encoder.log_scale_min) \
            * gaussian_encoder.log_step_recip
        self.last_floats = (y_res, idx_f)
        idx = idx_f.astype(np.uint8)
        q = np.clip(y_q, -128, 127).astype(np.int16)
        packed = (q << 8) | idx.astype(np.int16)
        gaussian_encoder.encode_y_packed(packed.reshape(-1))
        return y_pad[2:-2, 2:-2]

    def decode(self, prior, gaussian_encoder):
        """prior: (H, W, Cp).  Decodes one pixel vector a step; returns
        y_hat (H, W, C) float64."""
        hgt, wid = prior.shape[0], prior.shape[1]
        prior = np.asarray(prior, np.float64)
        c = self.cin
        y_pad = np.zeros((hgt + 4, wid + 4, c))
        smin = gaussian_encoder.SCALE_MIN
        smax = gaussian_encoder.SCALE_MAX
        for h in range(hgt):
            for w in range(wid):
                ctx = self._ctx_at(y_pad, h, w)
                means, scales = self._entropy_params(prior[h, w], ctx)
                sc = np.clip(scales, smin, smax)
                idx = ((np.log(sc) - gaussian_encoder.log_scale_min)
                       * gaussian_encoder.log_step_recip).astype(np.uint8)
                gaussian_encoder.decode_y(idx)
                q = gaussian_encoder.get_y((c,)).astype(np.float64)
                y_pad[h + 2, w + 2] = q + means
        return y_pad[2:-2, 2:-2]


def host_hwc(t):
    """Start copying a (1, C, H, W) plane to the host as float32 (H, W, C);
    returns fetch_async's callable."""
    return fetch_async(t[0].permute(1, 2, 0).float().contiguous())


def from_host_hwc(a, device, dtype):
    """A float64 (H, W, C) plane from the host -> (1, C, H, W) `dtype` on
    `device`, each value rounded once."""
    return C.from_host_nhwc(a[None], device, torch.float64).to(dtype)


# ---------------------------------------------------------------------------
# host orchestrator
# ---------------------------------------------------------------------------

class DCVCNet:
    """The original DCVC P-frame codec.  compress / decompress exchange
    four separate strings (mv_z, mv_y, z, y), as the reference's
    CompressAI-era API does.

    device: torch device (default cuda; without CUDA that raises, and the
    CPU runs only when asked for).  dtype: float32 or bfloat16
    activations."""

    def __init__(self, device="cuda", dtype=torch.float32):
        C.check_dtype(dtype, "DCVCNet")
        self.device = C.resolve_device(device)
        self.dtype = dtype
        self.params = None
        self.entropy_coder = None
        self.bit_estimator_z = BitEstimator(1, CH_N, support=50)
        self.bit_estimator_z_mv = BitEstimator(1, CH_N, support=50)
        self.gaussian_encoder = GaussianEncoder(
            distribution="laplace", scale_min=0.01, scale_max=64.0,
            scale_levels=256, support=50)
        self._ar = None
        self._ar_mv = None

    def init_params(self, seed=0):
        """The port's random init (torch.Generator), not the JAX
        package's draws; nothing is cast."""
        gen = torch.Generator().manual_seed(seed)
        self.load_params(dcvc_init(gen))
        return self.params

    def load_params(self, params):
        self.params = to_device(params, self.device)

    def update(self):
        """A new host coder with the Laplace scale rows and both z tables
        registered (groups 0, 1 and 2), and the two AR coders' weights on
        the host."""
        self.entropy_coder = EntropyCoder()
        self.gaussian_encoder.update(self.entropy_coder)
        self.bit_estimator_z.update(self.params["bit_estimator_z"],
                                    self.entropy_coder)
        self.bit_estimator_z_mv.update(self.params["bit_estimator_z_mv"],
                                       self.entropy_coder)
        self._ar = _ARCoder(self.params, "auto_regressive",
                            "entropy_parameters")
        self._ar_mv = _ARCoder(self.params, "auto_regressive_mv",
                               "entropy_parameters_mv")

    def _flush_segment(self):
        self.entropy_coder.flush()
        seg = self.entropy_coder.get_encoded_stream()
        self.entropy_coder.reset()
        return seg

    def _fetch(self, *fetches):
        """Wait for host copies started together (fetch_async's
        callables); numpy."""
        return [f() for f in fetches]

    def _upload(self, a):
        return from_host_hwc(a, self.device, self.dtype)

    def compress(self, ref_frame, x):
        """ref_frame, x: (1, H, W, 3) NHWC in [0, 1], H and W multiples of
        64.  Returns {"mv_z_string", "mv_y_string", "z_string",
        "y_string": bytes, "recon_image": NHWC}."""
        p = self.params
        x = C.frame_to_nchw(x, self.device, self.dtype)
        ref = C.frame_to_nchw(ref_frame, self.device, self.dtype)

        mv_y, mv_z_hat, mv_z_int8 = _stage_mv_front(p, x, ref)
        params_mv = _stage_mv_prior_params(p, mv_z_hat)
        mv_z_np, mv_y_np, params_mv_np = self._fetch(
            fetch_async(C.nhwc_flat(mv_z_int8)), host_hwc(mv_y),
            host_hwc(params_mv))
        self.entropy_coder.reset()
        self.bit_estimator_z_mv.encode_z(mv_z_np, 0)
        mv_z_string = self._flush_segment()
        mv_y_hat = self._upload(self._ar_mv.encode(
            mv_y_np, params_mv_np, self.gaussian_encoder))
        mv_y_string = self._flush_segment()

        ctx = _stage_after_mv(p, ref, mv_y_hat)
        y, z_hat, z_int8 = _stage_ctx_front(p, x, ctx)
        prior = _stage_y_prior_params(p, z_hat, _stage_temporal(p, ctx))
        z_np, y_np, prior_np = self._fetch(fetch_async(C.nhwc_flat(z_int8)),
                                           host_hwc(y), host_hwc(prior))
        self.bit_estimator_z.encode_z(z_np, 0)
        z_string = self._flush_segment()
        y_hat = self._upload(self._ar.encode(y_np, prior_np,
                                             self.gaussian_encoder))
        y_string = self._flush_segment()

        recon = _stage_recon(p, y_hat, ctx)
        return {"mv_z_string": mv_z_string, "mv_y_string": mv_y_string,
                "z_string": z_string, "y_string": y_string,
                "recon_image": C.frame_to_nhwc(recon)}

    def decompress(self, ref_frame, mv_y_string, mv_z_string, y_string,
                   z_string, height, width):
        """Returns the frame, NHWC (1, H, W, 3).  A segment that is not
        exactly its symbols raises ValueError."""
        p = self.params
        ref = C.frame_to_nchw(ref_frame, self.device, self.dtype)
        zh, zw = C.get_downsampled_shape(height, width, 64)

        self.entropy_coder.set_stream(mv_z_string)
        mv_z_hat = C.decode_z_host(self.bit_estimator_z_mv, 0, zh, zw,
                                   self.device, self.dtype)
        self.entropy_coder.check_stream_end()
        (params_mv,) = self._fetch(host_hwc(_stage_mv_prior_params(
            p, mv_z_hat)))
        self.entropy_coder.set_stream(mv_y_string)
        mv_y_hat = self._upload(self._ar_mv.decode(params_mv,
                                                   self.gaussian_encoder))
        self.entropy_coder.check_stream_end()

        ctx = _stage_after_mv(p, ref, mv_y_hat)
        self.entropy_coder.set_stream(z_string)
        z_hat = C.decode_z_host(self.bit_estimator_z, 0, zh, zw, self.device,
                                self.dtype)
        self.entropy_coder.check_stream_end()
        (prior,) = self._fetch(host_hwc(_stage_y_prior_params(
            p, z_hat, _stage_temporal(p, ctx))))
        self.entropy_coder.set_stream(y_string)
        y_hat = self._upload(self._ar.decode(prior, self.gaussian_encoder))
        self.entropy_coder.check_stream_end()
        return C.frame_to_nhwc(_stage_recon(p, y_hat, ctx))
