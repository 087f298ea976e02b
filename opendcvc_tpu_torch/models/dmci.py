"""DMCI — the DCVC-RT intra codec (NCHW).

Counterpart of the JAX package's `models/dmci.py`: pixel-unshuffle 8, enc/dec
width 368, y N = 256 at 1/16, z 128 at 1/64, a four-pass quadtree
checkerboard prior.  Host EC (the default): z and the four passes' packed
planes cross to the host in one copy and the C++ rANS coder codes them;
the decoder decodes z on the host, then for each pass fetches its CDF
indexes and uploads its decoded symbols.  Device EC: the five symbol
planes are coded back to back per lane by one K1 launch against the
combined [y rows | z subtable] table and decoded by five K2 launches (z,
y0..y3) that carry one rANS state per lane; the container is the JAX
package's v6.  Skip compaction (opt-in, as DMC's) codes each quarter's
kept symbols in kyc steps a lane.  Both write the JAX package's bytes.
Stages both sides evaluate are shared functions (see models/dmc.py for
the bit-exactness contract).
"""

import functools
import math
import threading

import numpy as np
import torch

from ..entropy.device_rans import (StagingPlan, _undensify_device,
                                   effective_lanes, fetch_staging,
                                   full_range_cdf_rows, slim_fetch,
                                   staging_width, upload_stagings)
from ..entropy.coder import EntropyCoder
from ..entropy.models import (BitEstimator, GaussianEncoder,
                              bit_estimator_init)
from ..layers import blocks as L
from ..ops import fused as F
from ..ops.lane_rans import (prepare_decode_table,
                              prepare_encode_table)
from ..utils import trace
from ..utils.common import env_flag
from ..utils.params import cast_floating, to_device
from . import common as C
from .dmc import (_cm_unflat, _dcb_seq, _dec_plane, _dec_y_plane,
                  _indexes_of, _kyc_for, _launcher,
                  _operand, _pack_host, _settle, _z_rows)

G_CH_SRC = 3 * 8 * 8
G_CH_ENC_DEC = 368


def dmci_init(gen, N=256, z_channel=128, qp_num=C.QP_NUM,
              enc_dec_ch=G_CH_ENC_DEC):
    dcb = L.depth_conv_block_init
    p = {}
    p["enc1"] = dcb(gen, G_CH_SRC, enc_dec_ch)
    p["enc2"] = [dcb(gen, enc_dec_ch, enc_dec_ch) for _ in range(6)]
    p["enc_down"] = L.conv_init(gen, enc_dec_ch, N, 3)
    p["hyper_enc"] = [dcb(gen, N, z_channel),
                      L.res_block_stride2_init(gen, z_channel, z_channel),
                      L.res_block_stride2_init(gen, z_channel, z_channel)]
    p["hyper_dec"] = [L.res_block_upsample_init(gen, z_channel, z_channel),
                      L.res_block_upsample_init(gen, z_channel, z_channel),
                      dcb(gen, z_channel, N)]
    p["y_prior_fusion"] = [dcb(gen, N, N * 2), dcb(gen, N * 2, N * 2),
                           dcb(gen, N * 2, N * 2),
                           L.conv_init(gen, N * 2, N * 2 + 2, 1)]
    p["reduction"] = L.conv_init(gen, N * 2 + 2, N, 1)
    for k in (1, 2, 3):
        p[f"adaptor_{k}"] = dcb(gen, N * 2, N * 2, force_adaptor=True)
    p["y_spatial_prior"] = [dcb(gen, N * 2, N * 2) for _ in range(3)] \
        + [L.conv_init(gen, N * 2, N * 2, 1)]
    p["dec1_up"] = L.res_block_upsample_init(gen, N, enc_dec_ch)
    p["dec1"] = [dcb(gen, enc_dec_ch, enc_dec_ch) for _ in range(12)]
    p["dec2"] = dcb(gen, enc_dec_ch, G_CH_SRC)
    # log-spaced rate ladder, qp 0 = highest rate (the JAX package's init)
    ladder = torch.exp(torch.linspace(math.log(4.0), math.log(0.4),
                                      qp_num))[:, None]
    p["q_scale_enc"] = torch.ones((qp_num, enc_dec_ch)) * ladder
    p["q_scale_dec"] = torch.ones((qp_num, enc_dec_ch)) / ladder
    p["bit_estimator_z"] = bit_estimator_init(gen, qp_num, z_channel)
    return p


# ---------------------------------------------------------------------------
# sub-networks and stages
# ---------------------------------------------------------------------------

def intra_encoder(p, x, q_enc):
    out = L.depth_conv_block_apply(p["enc1"], F.space_to_depth(x, 8),
                                   quant_step=q_enc)
    out = _dcb_seq(p["enc2"], out)
    return L.conv_apply(p["enc_down"], out, stride=2, padding=1)


def intra_decoder(p, y_hat, q_dec):
    out = L.res_block_upsample_apply(p["dec1_up"], y_hat)
    out = _dcb_seq(p["dec1"][:-1], out)
    out = L.depth_conv_block_apply(p["dec1"][-1], out, quant_step=q_dec)
    out = L.depth_conv_block_apply(p["dec2"], out)
    return F.depth_to_space(out, 8)


def hyper_encoder(p, y_pad):
    h = L.depth_conv_block_apply(p["hyper_enc"][0], y_pad)
    h = L.res_block_stride2_apply(p["hyper_enc"][1], h)
    return L.res_block_stride2_apply(p["hyper_enc"][2], h)


def hyper_decoder(p, z_hat):
    h = L.res_block_upsample_apply(p["hyper_dec"][0], z_hat)
    h = L.res_block_upsample_apply(p["hyper_dec"][1], h)
    return L.depth_conv_block_apply(p["hyper_dec"][2], h)


def prior_fusion(p, params_in):
    h = _dcb_seq(p["y_prior_fusion"][:3], params_in)
    return L.conv_apply(p["y_prior_fusion"][3], h)


def spatial_prior(p, adaptor_p, x):
    h = L.depth_conv_block_apply(adaptor_p, x)
    h = _dcb_seq(p["y_spatial_prior"][:3], h)
    return L.conv_apply(p["y_spatial_prior"][3], h)


@trace.spanned("nn.enc_front")
def _stage_enc_front(p, x, qp):
    """Encoder-only: frame -> y, rounded z."""
    y = intra_encoder(p, x, C.q_vec(p["q_scale_enc"], qp, x.dtype))
    z = hyper_encoder(p, C.pad_for_y(y))
    z_hat, z_int8 = F.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


@trace.spanned("nn.prior")
def _stage_prior(p, z_hat, y_h, y_w):
    """Shared: z_hat -> separated prior + reduced context."""
    params = prior_fusion(p, hyper_decoder(p, z_hat))
    params = params[:, :, :y_h, :y_w]
    q_enc, q_dec, scales, means = C.separate_prior_image(params)
    reduced = L.conv_apply(p["reduction"], params)
    return q_enc, q_dec, scales, means, reduced


@trace.spanned("nn.spatial")
def _stage_spatial(p, k, y_hat_so_far, reduced):
    """Shared: spatial-prior pass k in {1, 2, 3} -> (scales, means)."""
    out = spatial_prior(p, p[f"adaptor_{k}"],
                        torch.cat((y_hat_so_far, reduced), dim=1))
    c = out.shape[1] // 2
    return out[:, :c], out[:, c:]


def _masks_4x(t):
    _, c, h, w = t.shape
    return F.checkerboard_masks_4x(h, w, c, t.dtype, t.device)


@trace.spanned("nn.fold_index")
def _stage_fold_index(scales, k, force_zero_thres):
    """Shared: fold the active-quarter scales, build CDF indexes."""
    return _indexes_of(F.fold_quarters(scales * _masks_4x(scales)[k]),
                       force_zero_thres)


@trace.spanned("nn.enc_pass")
def _stage_enc_pass(y_s, scales, means, y_hat_so_far, k, force_zero_thres):
    """Encoder-only pass k: masked quantization -> (folded symbols int32,
    indexes, keep mask, running y_hat)."""
    mask = _masks_4x(y_s)[k]
    _, y_q, y_hat_k, _ = F.process_with_mask(y_s, scales, means, mask,
                                             force_zero_thres)
    idx, keep = _indexes_of(F.fold_quarters(scales * mask),
                            force_zero_thres)
    so_far = y_hat_k if y_hat_so_far is None else y_hat_so_far + y_hat_k
    return F.fold_quarters(y_q).to(torch.int32), idx, keep, so_far


@trace.spanned("nn.dec_restore")
def _stage_dec_restore(y_q_r, means, y_hat_so_far, k):
    """Decoder-only: scatter decoded symbols through mask k, accumulate."""
    y_hat_k = F.restore_y_4x(y_q_r, means, _masks_4x(means)[k])
    return y_hat_k if y_hat_so_far is None else y_hat_so_far + y_hat_k


@trace.spanned("nn.recon")
def _stage_recon(p, y_hat_so_far, q_dec_prior, qp):
    """Shared: final dequant + intra decoder + clamp."""
    y_hat = y_hat_so_far * q_dec_prior
    x_hat = intra_decoder(p, y_hat, C.q_vec(p["q_scale_dec"], qp,
                                            y_hat.dtype))
    return torch.clamp(x_hat, 0.0, 1.0)


# ---------------------------------------------------------------------------
# per-frame encoder and decoder
# ---------------------------------------------------------------------------

def _encode_stages_i(p, x, qp, fz=None):
    """Frame -> (x_hat NCHW, z int8, [(symbols, indexes, keep) of the
    passes y0..y3])."""
    y, z_hat, z_int8 = _stage_enc_front(p, x, qp)
    q_enc, q_dec_prior, scales, means, reduced = _stage_prior(
        p, z_hat, y.shape[2], y.shape[3])
    y_s = y * q_enc
    planes, so_far = [], None
    for k in range(4):
        if k > 0:
            scales, means = _stage_spatial(p, k, so_far, reduced)
        sym, idx, keep, so_far = _stage_enc_pass(y_s, scales, means,
                                                 so_far, k, fz)
        planes.append((sym, idx, keep))
    return _stage_recon(p, so_far, q_dec_prior, qp), z_int8, planes


def _compress_frame_i(p, x, qp, lanes, n_y_rows, fz=None, kyc=0):
    """Device EC: frame -> (x_hat NCHW, the K1 operand over y3..y0 then z,
    `_operand`'s callable of the compaction rung, first kyc)."""
    x_hat, z_int8, planes = _encode_stages_i(p, x, qp, fz)
    return x_hat, _operand(planes[::-1], z_int8, lanes, n_y_rows, fz, kyc)


def _decompress_frame_i(p, staging, qp, dec_table, n_y_rows, zh, zw, y_h,
                        y_w, z_channel, lanes, cap, mw, dtype, fz=None,
                        kyc=0):
    """Compact staging -> x_hat (NCHW, `dtype`); the K2 launches read row
    slices of the prepared decode table."""
    data, states = _undensify_device(staging, cap, lanes, mw)
    carry = (states, torch.zeros((lanes,), dtype=torch.int32,
                                 device=data.device))
    z_base = n_y_rows + qp * z_channel
    z_flat, carry = _dec_plane(data,
                               _z_rows(zh * zw * z_channel, z_channel,
                                       data.device),
                               dec_table[z_base:z_base + z_channel], carry,
                               lanes)
    z_hat = _cm_unflat(z_flat, (1, z_channel, zh, zw)).to(dtype)
    _, q_dec_prior, scales, means, reduced = _stage_prior(p, z_hat, y_h,
                                                          y_w)
    dec_y = dec_table[:n_y_rows]
    so_far = None
    for k in range(4):
        if k > 0:
            scales, means = _stage_spatial(p, k, so_far, reduced)
        idx, keep = _stage_fold_index(scales, k, fz)
        y_flat, carry = _dec_y_plane(data, idx, keep, dec_y, carry, lanes,
                                     fz, kyc)
        y_q_r = _cm_unflat(y_flat, idx.shape).to(means.dtype)
        so_far = _stage_dec_restore(y_q_r, means, so_far, k)
    return _stage_recon(p, so_far, q_dec_prior, qp)


# ---------------------------------------------------------------------------
# host orchestrator
# ---------------------------------------------------------------------------

class DMCI:
    """DCVC-RT intra codec.

    device_ec: code the symbols on the device (K1/K2) instead of with the
    host coder (the default), as DMC.  lanes and bytes_per_symbol size the
    device-EC lane rANS staging; each one not given is read from
    OPENDCVC_TPU_EC_LANES / _EC_BPS (defaults 4096, 0.5), as the JAX
    package reads them.  Skip compaction reads
    OPENDCVC_TPU_EC_SKIP_COMPACT / _EC_SKIP_FRAC as DMC does.  The
    cap fraction stays 0.5: the JAX package's DMCI does not read
    OPENDCVC_TPU_EC_CAP_FRAC.  `transfers` counts the
    host-EC copies, as DMC's.

    Device EC also codes batches of independent frames:
    `compress_batch(_async)` and `decompress_batch` run each frame through
    the single-frame path's stages with one device->host copy or one
    upload for the batch, and write and read compress()'s streams.

    dtype: the activations' dtype (float32 or torch.bfloat16), as the JAX
    package's `DMCI(dtype=)`: frames are cast to it, init_params casts the
    float32 init to it, load_params keeps the loaded dtypes."""

    def __init__(self, N=256, z_channel=128, enc_dec_ch=G_CH_ENC_DEC,
                 device="cuda", device_ec=False, lanes=None,
                 bytes_per_symbol=None, dtype=torch.float32):
        self.device = C.resolve_device(device)
        self.device_ec = device_ec
        self.dtype = dtype
        self.N = N
        self.z_channel = z_channel
        self.enc_dec_ch = enc_dec_ch
        self.lanes = C.ec_setting(lanes, "OPENDCVC_TPU_EC_LANES", 4096)
        self.bytes_per_symbol = C.ec_setting(
            bytes_per_symbol, "OPENDCVC_TPU_EC_BPS", 0.5)
        self.skip_compact = env_flag("OPENDCVC_TPU_EC_SKIP_COMPACT")
        self.skip_frac = C.ec_setting(None, "OPENDCVC_TPU_EC_SKIP_FRAC", 0.5)
        self.params = None
        self.bit_estimator_z = BitEstimator(C.QP_NUM, z_channel)
        self.gaussian_encoder = GaussianEncoder()
        self.force_zero_thres = None
        self.entropy_coder = None
        self.transfers = {"d2h": 0, "h2d": 0}
        self.enc_table = None
        self.dec_table = None
        self.n_y_rows = 0
        # learned launch staging rate per (H, W) (see DMC._ec_learned)
        self._ec_learned = {}
        self._ec_rerun_count = 0
        self._ec_lock = threading.Lock()
        # the encode copy's window for each staging capacity
        # (entropy/device_rans.py::slim_fetch)
        self._fetch_windows = {}

    # -- setup ---------------------------------------------------------------

    def init_params(self, seed=0):
        """Draw in float32, then cast the float32 leaves to the codec's
        dtype."""
        gen = torch.Generator().manual_seed(seed)
        self.params = to_device(cast_floating(
            dmci_init(gen, self.N, self.z_channel,
                      enc_dec_ch=self.enc_dec_ch), self.dtype), self.device)
        return self.params

    def load_params(self, params):
        self.params = to_device(params, self.device)

    def update(self, force_zero_thres=None):
        """Build the CDF tables (y scale rows, then z rows by qp, channel).
        Host EC: register them with a new host coder (groups 0 and 1).
        Device EC: K1 and K2 read slices of their prepared forms,
        `enc_table` and `dec_table`."""
        self.force_zero_thres = force_zero_thres
        if not self.device_ec:
            self.entropy_coder = EntropyCoder()
            self.gaussian_encoder.update(self.entropy_coder,
                                         force_zero_thres)
            self.bit_estimator_z.update(self.params["bit_estimator_z"],
                                        self.entropy_coder)
            return
        y_rows = full_range_cdf_rows(*self.gaussian_encoder.update())
        z_rows = full_range_cdf_rows(
            *self.bit_estimator_z.update(self.params["bit_estimator_z"]))
        self.n_y_rows = y_rows.shape[0]
        table = torch.from_numpy(
            np.concatenate([y_rows, z_rows])).to(self.device)
        self.enc_table = prepare_encode_table(table)
        self.dec_table = prepare_decode_table(table)

    def set_use_two_entropy_coders(self, b):
        """Split each plane between two host coders (the harness's choice
        above 1280x720); no effect with device EC."""
        if self.entropy_coder is not None:
            self.entropy_coder.set_use_two_entropy_coders(b)

    # -- compress ------------------------------------------------------------

    def _plan(self, H, W):
        """The StagingPlan of a frame size: lane count (scaled to the
        symbol count), steps a lane of z and of each y quarter, and the
        first skip-compaction rung."""
        y_h, y_w = C.get_downsampled_shape(H, W, 16)
        zh, zw = C.get_downsampled_shape(H, W, 64)
        n_y = y_h * y_w * self.N // 4
        n_z = zh * zw * self.z_channel
        lanes = effective_lanes(self.lanes, 4 * n_y + n_z)
        k_y = -(-n_y // lanes)
        return StagingPlan(lanes, -(-n_z // lanes), k_y, 4,
                           _kyc_for(k_y, self.force_zero_thres,
                                    self.skip_compact, self.skip_frac))

    @staticmethod
    def _rung(lanes, k_total, bps):
        """(mw, cap) of the staging ladder at `bps` bytes per symbol; the
        top rung (bps 3.0) takes the whole rectangle."""
        mw = staging_width(k_total, bps)
        return mw, lanes * mw if bps >= 3.0 else max(4096, lanes * mw // 2)

    def _launch_i(self, x, qp):
        """Device EC: queue a frame's (NCHW) stages and its K1 launch.
        Returns (x_hat NHWC, the staging on the device, start_fetch,
        settle): start_fetch(staging, or a stack of stagings of this rung)
        starts their windowed copy to the host (slim_fetch) and returns
        its finisher; settle(host staging) serializes the frame's stream,
        re-running its K1 alone at a grown rung when the staging
        overflowed."""
        H, W = x.shape[2], x.shape[3]
        bps = max(self.bytes_per_symbol, self._ec_learned.get((H, W), 0.0))
        plan = self._plan(H, W)
        x_hat, operand = _compress_frame_i(self.params, x, qp, plan.lanes,
                                           self.n_y_rows,
                                           self.force_zero_thres, plan.kyc)
        launch = _launcher(operand, self.enc_table, self.n_y_rows, qp,
                           self.z_channel)

        def settle(arr):
            return _settle(self, arr, (H, W), plan, bps,
                           lambda mw, cap, kyc: fetch_staging(
                               launch(mw, cap, kyc))())

        mw, cap = self._rung(plan.lanes, plan.steps(), bps)
        return (C.frame_to_nhwc(x_hat), launch(mw, cap, plan.kyc),
                functools.partial(slim_fetch, self._fetch_windows,
                                  lanes=plan.lanes, cap=cap),
                settle)

    def compress_async(self, x, qp):
        """Device-EC encode of one frame (as compress): queues its stages
        and its K1 launch and starts the staging's copy to the host.
        Returns (x_hat NHWC, finish) without waiting for the copy;
        finish() returns the bit stream."""
        if not self.device_ec:
            raise ValueError("compress_async requires device-EC mode")
        with trace.span("dmci.compress", 1):
            x_hat, staging, start_fetch, settle = self._launch_i(
                C.frame_to_nchw(x, self.device, self.dtype), int(qp))
            fetch = start_fetch(staging)
            ids = trace.frame_ids()

        def finish():
            with trace.span("dmci.finish", ids):
                return settle(fetch())

        return x_hat, finish

    def compress_batch_async(self, xs, qps):
        """Batched device-EC encode of B independent frames: xs a list of
        (1, H, W, 3) frames or a stacked (B, 1, H, W, 3) array, qps an int
        or B ints.  Each frame runs the single-frame path's stages and K1
        launch, and ONE copy brings the B stagings to the host.  Returns
        (x_hats (B, 1, H, W, 3), finish), finish() the B bit streams that
        compress() writes; a frame that overflowed re-runs alone."""
        if not self.device_ec:
            raise ValueError("compress_batch_async requires device-EC mode")
        frames = list(xs)
        qps = [int(qps)] * len(frames) if np.isscalar(qps) \
            else [int(q) for q in qps]
        if len(qps) != len(frames):
            raise ValueError(f"{len(qps)} qps for {len(frames)} frames")
        launched = [self._launch_i(C.frame_to_nchw(x, self.device,
                                                   self.dtype), qp)
                    for x, qp in zip(frames, qps)]
        # one plan and rung for frames of one size: one windowed copy
        fetch = launched[0][2](torch.stack([s for _, s, _, _ in launched]))

        def finish():
            arr = fetch()
            return [settle(arr[i]) for i, (_, _, _, settle) in
                    enumerate(launched)]

        return torch.stack([x_hat for x_hat, _, _, _ in launched]), finish

    def compress_batch(self, xs, qps):
        x_hats, finish = self.compress_batch_async(xs, qps)
        return {"bit_streams": finish(), "x_hat": x_hats}

    def compress(self, x, qp):
        """x: (1, H, W, 3) NHWC in [0, 1], H and W multiples of 16.
        Returns {"bit_stream": bytes, "x_hat": NHWC tensor}."""
        if not self.device_ec:
            return self._compress_host(
                C.frame_to_nchw(x, self.device, self.dtype), qp)
        x_hat, finish = self.compress_async(x, qp)
        return {"bit_stream": finish(), "x_hat": x_hat}

    @trace.spanned("dmci.compress", 1)
    def _compress_host(self, x, qp):
        """Host EC: one copy of z, the four packed planes and (with
        force_zero_thres) their skip masks, then the host coder."""
        fz = self.force_zero_thres
        x_hat, z_int8, planes = _encode_stages_i(self.params, x, qp, fz)
        buf = C.fetch_async(_pack_host(z_int8, planes, fz))()
        self.transfers["d2h"] += 1
        stream = C.code_host(self.entropy_coder,
                             [(self.bit_estimator_z, qp)],
                             self.gaussian_encoder, buf, [z_int8.numel()],
                             [planes[0][0].numel()] * len(planes),
                             fz is not None)
        return {"bit_stream": stream, "x_hat": C.frame_to_nhwc(x_hat)}

    # -- decompress ----------------------------------------------------------

    def _decompress_host(self, bit_stream, sps, qp):
        """Host EC: z decoded on the host, then for each pass its indexes
        fetched (the host waits), decoded and the symbols uploaded.  A
        stream that is not exactly the frame's symbols raises ValueError."""
        p, fz, coder = self.params, self.force_zero_thres, self.entropy_coder
        zh, zw = C.get_downsampled_shape(sps["height"], sps["width"], 64)
        y_h, y_w = C.get_downsampled_shape(sps["height"], sps["width"], 16)
        coder.set_use_two_entropy_coders(sps["ec_part"] == 1)
        coder.set_stream(bit_stream)
        z_hat = C.decode_z_host(self.bit_estimator_z, qp, zh, zw, self.device,
                                self.dtype, self.transfers)
        _, q_dec_prior, scales, means, reduced = _stage_prior(p, z_hat, y_h,
                                                              y_w)
        so_far = None
        for k in range(4):
            if k > 0:
                scales, means = _stage_spatial(p, k, so_far, reduced)
            idx, keep = _stage_fold_index(scales, k, fz)
            y_q_r = C.decode_y_host(
                self.gaussian_encoder, C.fetch_async(C.index_buf(idx, keep)),
                idx.shape, self.device, means.dtype, self.transfers,
                fz is not None)
            so_far = _stage_dec_restore(y_q_r, means, so_far, k)
        coder.check_stream_end()
        return _stage_recon(p, so_far, q_dec_prior, qp)

    @trace.spanned("dmci.decompress", 1)
    def decompress(self, bit_stream, sps, qp):
        """Returns {"x_hat": NHWC (1, H, W, 3)}.  Host EC reads the coder
        split from sps["ec_part"]."""
        if not self.device_ec:
            return {"x_hat": C.frame_to_nhwc(
                self._decompress_host(bit_stream, sps, qp))}
        metas, stagings = upload_stagings([bit_stream], self.device)
        return {"x_hat": self._decode_staged(metas[0], stagings[0], sps, qp)}

    def _decode_staged(self, meta, staging, sps, qp):
        """Device-EC decoder on an uploaded staging; returns x_hat NHWC."""
        zh, zw = C.get_downsampled_shape(sps["height"], sps["width"], 64)
        y_h, y_w = C.get_downsampled_shape(sps["height"], sps["width"], 16)
        return C.frame_to_nhwc(_decompress_frame_i(
            self.params, staging, qp, self.dec_table, self.n_y_rows, zh, zw,
            y_h, y_w, self.z_channel, meta["L"], meta["cap"], meta["MW"],
            self.dtype, self.force_zero_thres, meta["kyc"]))

    def decompress_batch(self, bit_streams, sps, qps):
        """Batched device-EC decode of B independent streams at `qps` (an
        int or B ints): one upload for the batch, then each frame through
        the single-frame decoder's stages; a batch of mixed ladder rungs
        decodes frame by frame.  Returns {"x_hat": (B, 1, H, W, 3)}."""
        if not self.device_ec:
            raise ValueError("decompress_batch requires device-EC mode")
        qps = [int(qps)] * len(bit_streams) if np.isscalar(qps) \
            else [int(q) for q in qps]
        if len(qps) != len(bit_streams):
            raise ValueError(f"{len(qps)} qps for {len(bit_streams)} streams")
        metas, stagings = upload_stagings(bit_streams, self.device)
        if stagings is None:
            return {"x_hat": torch.stack(
                [self.decompress(s, sps, q)["x_hat"]
                 for s, q in zip(bit_streams, qps)])}
        return {"x_hat": torch.stack(
            [self._decode_staged(metas[0], st, sps, q)
             for st, q in zip(stagings, qps)])}
