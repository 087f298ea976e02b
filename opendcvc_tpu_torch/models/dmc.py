"""DMC — the DCVC-RT P-frame codec (NCHW).

Counterpart of the JAX package's `models/dmc.py`.  A propagated decoder-side
feature (256 channels at 1/8 resolution) carries temporal context; a
single latent (128 channels at 1/16) is coded with a two-pass
checkerboard prior fused from hyper and temporal priors; per-QP banks
modulate the stages.

Bit-exactness contract: every stage both the encoder and the decoder
evaluate is one shared function called on identically shaped tensors, and
the package pins cuDNN to deterministic algorithms (full float32, no
TF32), so the temporal feature chain cannot drift between the two sides,
in float32 or in bfloat16 (`dtype=`).

Entropy coding has two modes, as in the JAX package (`device_ec`):
  * host EC (the default): the frame's symbol planes (z, y0, y1) cross to
    the host in one copy, flattened NHWC, and the C++ rANS coder codes
    them in the DCVC family's stream format (`entropy/coder.py`).  The
    decoder decodes z on the host while the device runs the feature
    extractor, then fetches each y pass's CDF indexes and uploads its
    decoded symbols;
  * device EC: the three planes are coded back to back per lane by kernel
    K1 from one packed operand against a combined per-frame table (the y
    rows, then the frame QP's z rows), and decoded by three K2 launches
    that carry one rANS state per lane.  With force_zero_thres and skip
    compaction (OPENDCVC_TPU_EC_SKIP_COMPACT, off by default) each y
    plane's kept symbols are compacted into lanes * kyc slots first, so
    its launches run kyc steps in place of the plane's K_y.  The
    container is the JAX package's "tpu-lane" v6.  The K1 launch returns
    at once; the staging's copy to the host completes in the callable
    that compress_async returns.  GOP coding (device EC) runs N frames through the same
    stages with one copy or one upload for the chunk.  On a card the
    decoder's body (`_decompress_frame_core`, K2 launches included)
    replays from a CUDA graph captured once per frame size and container
    rung, qp being one of its inputs (utils/graph.py); on the CPU and
    under autograd it runs eagerly.
Both write the JAX package's bytes.
"""

import functools
import math
import threading

import numpy as np
import torch

from ..entropy.device_rans import (StagingPlan, _undensify_device,
                                   compact_skip_dec, compact_skip_enc,
                                   densify_segment, effective_lanes,
                                   expand_compact_syms, fetch_staging,
                                   full_range_cdf_rows, settle_staging,
                                   slim_fetch, staging_width,
                                   upload_stagings)
from ..entropy.coder import EntropyCoder
from ..entropy.models import (BitEstimator, GaussianEncoder,
                              bit_estimator_init)
from ..layers import blocks as L
from ..ops import fused as F
from ..ops.lane_rans import (DEC_SKIP, ENC_SKIP, decode_scan, encode_scan,
                              pack_operand, prepare_decode_table,
                              prepare_encode_table)
from ..utils import trace
from ..utils.common import env_flag
from ..utils.graph import BodyGraphs
from ..utils.params import cast_floating, to_device
from ..utils.transfer import fetch_async
from . import common as C

QP_SHIFT = [0, 8, 4]
EXTRA_QP = max(QP_SHIFT)

G_CH_SRC_D = 3 * 8 * 8
G_CH_RECON = 320
G_CH_Y = 128
G_CH_Z = 128
G_CH_D = 256


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dmc_init(gen, qp_num=C.QP_NUM):
    dcb = L.depth_conv_block_init
    p = {}
    p["feature_adaptor_i"] = dcb(gen, G_CH_SRC_D, G_CH_D)
    p["feature_adaptor_p"] = L.conv_init(gen, G_CH_D, G_CH_D, 1)
    p["fe_conv1"] = [dcb(gen, G_CH_D, G_CH_D) for _ in range(2)]
    p["fe_conv2"] = [dcb(gen, G_CH_D, G_CH_D) for _ in range(4)]
    p["enc_conv1"] = L.conv_init(gen, G_CH_SRC_D, G_CH_D, 1)
    p["enc_conv2"] = [dcb(gen, G_CH_D * 2, G_CH_D), dcb(gen, G_CH_D, G_CH_D)]
    p["enc_conv3"] = dcb(gen, G_CH_D, G_CH_D)
    p["enc_down"] = L.conv_init(gen, G_CH_D, G_CH_Y, 3)
    p["hyper_enc"] = [dcb(gen, G_CH_Y, G_CH_Z),
                      L.res_block_stride2_init(gen, G_CH_Z, G_CH_Z),
                      L.res_block_stride2_init(gen, G_CH_Z, G_CH_Z)]
    p["hyper_dec"] = [L.res_block_upsample_init(gen, G_CH_Z, G_CH_Z),
                      L.res_block_upsample_init(gen, G_CH_Z, G_CH_Z),
                      dcb(gen, G_CH_Z, G_CH_Y)]
    p["temporal_prior"] = L.res_block_stride2_init(gen, G_CH_D, G_CH_Y * 2)
    p["y_prior_fusion"] = [dcb(gen, G_CH_Y * 3, G_CH_Y * 3)
                           for _ in range(3)] \
        + [L.conv_init(gen, G_CH_Y * 3, G_CH_Y * 3, 1)]
    p["y_spatial_prior"] = [dcb(gen, G_CH_Y * 4, G_CH_Y * 3),
                            dcb(gen, G_CH_Y * 3, G_CH_Y * 3),
                            L.conv_init(gen, G_CH_Y * 3, G_CH_Y * 2, 1)]
    p["dec_up"] = L.subpel_conv2x_init(gen, G_CH_Y, G_CH_D, 3)
    p["dec_conv1"] = [dcb(gen, G_CH_D * 2, G_CH_D),
                      dcb(gen, G_CH_D, G_CH_D), dcb(gen, G_CH_D, G_CH_D)]
    p["dec_conv2"] = L.conv_init(gen, G_CH_D, G_CH_D, 1)
    p["recon_conv"] = [dcb(gen, G_CH_D, G_CH_RECON)] \
        + [dcb(gen, G_CH_RECON, G_CH_RECON) for _ in range(3)]
    p["recon_head"] = L.conv_init(gen, G_CH_RECON, G_CH_SRC_D, 1)

    n_qp = qp_num + EXTRA_QP
    # log-spaced rate ladder, qp 0 = highest rate (the JAX package's init)
    ladder = torch.exp(torch.linspace(math.log(4.0), math.log(0.4),
                                      n_qp))[:, None]
    p["q_encoder"] = torch.ones((n_qp, G_CH_D)) * ladder
    p["q_decoder"] = torch.ones((n_qp, G_CH_D)) / ladder
    p["q_feature"] = torch.ones((n_qp, G_CH_D))
    p["q_recon"] = torch.ones((n_qp, G_CH_RECON))
    p["bit_estimator_z"] = bit_estimator_init(gen, n_qp, G_CH_Z)
    return p


# ---------------------------------------------------------------------------
# sub-networks and stages (shared = evaluated by both encoder and decoder)
# ---------------------------------------------------------------------------

def _dcb_seq(params_list, x):
    for bp in params_list:
        x = L.depth_conv_block_apply(bp, x)
    return x


def hyper_encoder(p, y_pad):
    h = L.depth_conv_block_apply(p["hyper_enc"][0], y_pad)
    h = L.res_block_stride2_apply(p["hyper_enc"][1], h)
    return L.res_block_stride2_apply(p["hyper_enc"][2], h)


def hyper_decoder(p, z_hat):
    h = L.res_block_upsample_apply(p["hyper_dec"][0], z_hat)
    h = L.res_block_upsample_apply(p["hyper_dec"][1], h)
    return L.depth_conv_block_apply(p["hyper_dec"][2], h)


def spatial_prior(p, x):
    h = L.depth_conv_block_apply(p["y_spatial_prior"][0], x)
    h = L.depth_conv_block_apply(p["y_spatial_prior"][1], h)
    return L.conv_apply(p["y_spatial_prior"][2], h)


@trace.spanned("nn.feature_adaptor_i")
def _stage_adaptor_i(p, frame):
    """Shared: pixel reference (NCHW) -> feature."""
    return L.depth_conv_block_apply(p["feature_adaptor_i"],
                                    F.space_to_depth(frame, 8))


@trace.spanned("nn.feature_adaptor_p")
def _stage_adaptor_p(p, feature):
    """Shared: propagated feature -> adapted feature."""
    return L.conv_apply(p["feature_adaptor_p"], feature)


@trace.spanned("nn.feature_extractor_part1")
def _stage_fe_part1(p, feature, qp):
    """Shared: first 2 blocks + temporal context."""
    x1 = _dcb_seq(p["fe_conv1"], feature)
    return x1, x1 * C.q_vec(p["q_feature"], qp, x1.dtype)


@trace.spanned("nn.feature_extractor_part2")
def _stage_fe_part2(p, x1):
    """Shared: remaining 4 blocks -> ctx."""
    return _dcb_seq(p["fe_conv2"], x1)


@trace.spanned("nn.encoder+hyper_enc")
def _stage_encode_y(p, x, ctx, qp):
    """Encoder-only: frame -> latent y + rounded z."""
    feat = L.conv_apply(p["enc_conv1"], F.space_to_depth(x, 8))
    feat = L.depth_conv_block_apply(p["enc_conv2"][0],
                                    torch.cat((feat, ctx), dim=1))
    feat = L.depth_conv_block_apply(p["enc_conv2"][1], feat)
    feat = L.depth_conv_block_apply(
        p["enc_conv3"], feat, quant_step=C.q_vec(p["q_encoder"], qp,
                                                 feat.dtype))
    y = L.conv_apply(p["enc_down"], feat, stride=2, padding=1)
    z = hyper_encoder(p, C.pad_for_y(y))
    z_hat, z_int8 = F.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


@trace.spanned("nn.hyper_dec+prior_fusion")
def _stage_prior(p, z_hat, ctx_t):
    """Shared: hyper + temporal priors -> fused prior params."""
    hier = hyper_decoder(p, z_hat)
    temporal = L.res_block_stride2_apply(p["temporal_prior"], ctx_t)
    th, tw = temporal.shape[2], temporal.shape[3]
    hier = hier[:, :, :th, :tw]
    fused = _dcb_seq(p["y_prior_fusion"][:3],
                     torch.cat((hier, temporal), dim=1))
    return L.conv_apply(p["y_prior_fusion"][3], fused)


@trace.spanned("nn.spatial_prior")
def _stage_spatial(p, y_hat_0, common_params):
    """Shared: second-pass spatial prior -> (scales, means)."""
    out = spatial_prior(p, torch.cat((y_hat_0, common_params), dim=1))
    c = out.shape[1] // 2
    return out[:, :c], out[:, c:]


_GE_IDX_CFG = (GaussianEncoder.SCALE_MIN, GaussianEncoder.SCALE_MAX,
               float(np.log(GaussianEncoder.SCALE_MIN)),
               (GaussianEncoder.SCALE_LEVELS - 1)
               / (np.log(GaussianEncoder.SCALE_MAX)
                  - np.log(GaussianEncoder.SCALE_MIN)))


def _indexes_of(scales_r, force_zero_thres):
    smin, smax, lsm, recip = _GE_IDX_CFG
    return F.build_index_dec(scales_r, smin, smax, lsm, float(recip),
                             force_zero_thres)


def _masks_2x(t):
    _, c, h, w = t.shape
    return F.checkerboard_masks_2x(h, w, c, t.dtype, t.device)


@trace.spanned("nn.fold_index_2x")
def _stage_fold_index_2x(scales, k, force_zero_thres):
    """Shared: fold the active-half scales, build CDF indexes and the keep
    mask."""
    return _indexes_of(F.fold_halves(scales * _masks_2x(scales)[k]),
                       force_zero_thres)


def _enc_pass(y, scales, means, k, force_zero_thres):
    """Encoder-only pass k: masked quantization -> (folded symbols int32,
    indexes, keep mask, y_hat_k)."""
    mask = _masks_2x(y)[k]
    _, y_q, y_hat_k, _ = F.process_with_mask(y, scales, means, mask,
                                             force_zero_thres)
    idx, keep = _indexes_of(F.fold_halves(scales * mask), force_zero_thres)
    return F.fold_halves(y_q).to(torch.int32), idx, keep, y_hat_k


@trace.spanned("nn.enc_pass0(fused)")
def _stage_enc_pass0(y, params_prior, force_zero_thres):
    """Encoder-only pass 0: prior separation + masked quantization."""
    y, _, scales, means = C.separate_prior_video_encoding(params_prior, y)
    sym, idx, keep, y_hat_0 = _enc_pass(y, scales, means, 0,
                                        force_zero_thres)
    return y, sym, idx, keep, y_hat_0


@trace.spanned("nn.enc_pass1(fused)")
def _stage_enc_pass1(y, scales, means, force_zero_thres):
    """Encoder-only pass 1 (y already divided by q_dec in pass 0)."""
    return _enc_pass(y, scales, means, 1, force_zero_thres)


@trace.spanned("nn.dec_index0")
def _stage_dec_index0(params_prior, force_zero_thres):
    """Decoder-only: pass-0 indexes (elementwise, so bit-identical to the
    encoder's pass-0 index computation)."""
    _, scales, _ = C.separate_prior_video_decoding(params_prior)
    return _stage_fold_index_2x(scales, 0, force_zero_thres)


@trace.spanned("nn.dec_restore_2x")
def _stage_dec_restore_2x(y_q_r, means, k):
    """Decoder-only: scatter decoded symbols back through mask k."""
    return F.restore_y_2x(y_q_r, means, _masks_2x(means)[k])


@trace.spanned("nn.latent_decoder(feature_out)")
def _stage_feature_out(p, y_hat_0, y_hat_1, params_prior, ctx, qp):
    """Shared: dequantized latent -> next reference feature."""
    c3 = params_prior.shape[1] // 3
    q_dec = torch.clamp_min(params_prior[:, :c3], 0.5)
    return _stage_feature(p, (y_hat_0 + y_hat_1) * q_dec, ctx, qp)


def _stage_feature(p, y_hat, ctx, qp):
    """Shared: latent decoder -> next reference feature."""
    feat = L.subpel_conv2x_apply(p["dec_up"], y_hat, padding=1)
    feat = torch.cat((feat, ctx), dim=1)
    for bp in p["dec_conv1"]:
        feat = L.depth_conv_block_apply(bp, feat)
    feat = L.conv_apply(p["dec_conv2"], feat)
    return feat * C.q_vec(p["q_decoder"], qp, feat.dtype)


@trace.spanned("nn.recon_generation")
def _stage_recon_x(p, feature, qp):
    """Shared: feature -> frame (NCHW)."""
    out = _dcb_seq(p["recon_conv"][:3], feature)
    out = L.depth_conv_block_apply(p["recon_conv"][3], out,
                                   quant_step=C.q_vec(p["q_recon"], qp,
                                                      out.dtype))
    return F.pixel_shuffle_clamp(L.conv_apply(p["recon_head"], out), 8)


# ---------------------------------------------------------------------------
# lane layout
# ---------------------------------------------------------------------------

def _cm_flat(plane):
    """Flatten a (1, C, H, W) plane channel-major: in NCHW a plain
    reshape.  Channel-major order makes each lane's symbols cycle through
    all channels and stride across space, so per-lane load hugs the mean
    (the JAX package's `_cm_flat` note)."""
    return plane.reshape(-1)


def _cm_unflat(flat, shape):
    """Inverse of _cm_flat."""
    return flat.reshape(shape)


def _lane_layout_t(flat, lanes, reverse):
    """Strided lane layout, step-major (K, L): flat index i -> lane
    i % lanes, step i // lanes.  Pads with zeros (symbol 0, row 0 of the
    plane's table); reverse=True flips the steps, since rANS encodes each
    lane's last symbol first."""
    n = flat.shape[0]
    k = -(-n // lanes)
    out = torch.cat([flat, flat.new_zeros(lanes * k - n)]).reshape(k, lanes)
    return out.flip(0) if reverse else out


def _lane_unlayout_t(sym_kl, n):
    """Inverse of _lane_layout_t (decode order)."""
    return sym_kl.reshape(-1)[:n]


def _z_rows(nz, c, device):
    """LOCAL row ids (channel = i // per-channel size) of a channel-major
    z plane into its qp's z subtable."""
    return torch.arange(nz, dtype=torch.int32, device=device) // (nz // c)


def _kyc_for(k_y, fz, skip_compact, skip_frac):
    """First-rung skip-compaction steps a lane of a y plane of k_y steps (0
    = off): a `skip_frac` share of k_y rounded up to a multiple of 8, at
    least min(k_y, 8) and at most k_y.  Only with force_zero_thres.  The
    JAX package's `DMC._kyc_for`, which measured compaction slower than
    the zero-rate skip slots on its chip, so it is opt-in there and
    here."""
    if fz is None or not skip_compact:
        return 0
    kyc = min(k_y, -(-int(np.ceil(k_y * skip_frac)) // 8) * 8)
    return max(kyc, min(k_y, 8))


def _pack_frame(y_planes, z_int8, lanes, n_y_rows, fz, kyc=0):
    """K1 operand of one frame: y planes (encode order) then z, each
    laid out step-major and reversed, packed (sym + 128) << 9 | row
    against the combined [y rows | z subtable] table.  With
    force_zero_thres, skipped y positions ride ENC_SKIP at zero rate, or,
    at a compaction rung kyc > 0, each y plane's survivors fill a lanes *
    kyc prefix whose tail rides ENC_SKIP.  Returns (operand, the largest
    survivor count of the y planes as a 0-d tensor, or None when kyc =
    0)."""
    pieces, m_max = [], None
    for sym, idx, keep in y_planes:
        sym, row = _cm_flat(sym), _cm_flat(idx).to(torch.int32)
        if fz is not None and kyc > 0:
            sym, row, m = compact_skip_enc(sym, row, _cm_flat(keep),
                                           lanes * kyc)
            m_max = m if m_max is None else torch.maximum(m_max, m)
        elif fz is not None:
            kf = _cm_flat(keep)
            row = torch.where(kf, row, ENC_SKIP)
            sym = torch.where(kf, sym, 0)
        pieces.append((_lane_layout_t(sym, lanes, True),
                       _lane_layout_t(row, lanes, True)))
    z_sym = _cm_flat(z_int8).to(torch.int32)
    z_rows = _z_rows(z_sym.shape[0], z_int8.shape[1], z_sym.device)
    # offset the z rows AFTER the layout, so pad slots land on the z
    # subtable's row 0 as in the JAX package's per-plane padding
    pieces.append((_lane_layout_t(z_sym, lanes, True),
                   _lane_layout_t(z_rows, lanes, True) + n_y_rows))
    return torch.cat([pack_operand(s, r) for s, r in pieces]), m_max


def _dec_plane(data, rows_flat, dec_table, carry, lanes):
    """One K2 launch over a flat plane of local row ids into a slice of
    the prepared decode table; returns (flat symbols, carry)."""
    n = rows_flat.shape[0]
    syms, state, ptr = decode_scan(data, _lane_layout_t(rows_flat, lanes,
                                                        False),
                                   dec_table, *carry)
    return _lane_unlayout_t(syms, n), (state, ptr)


def _dec_y_plane(data, idx, keep, dec_table, carry, lanes, fz, kyc=0):
    """Decode one y plane: its survivors compacted into lanes * kyc slots
    (kyc > 0, with force_zero_thres) and expanded back, or the full plane,
    skipped positions at K2's DEC_SKIP; the mapping comes from the shared
    keep mask, as on the encoder."""
    rows = _cm_flat(idx).to(torch.int32)
    if fz is not None and kyc > 0:
        rows_c, orig = compact_skip_dec(rows, _cm_flat(keep), lanes * kyc)
        syms_c, carry = _dec_plane(data, rows_c, dec_table, carry, lanes)
        return expand_compact_syms(syms_c, orig, rows.shape[0]), carry
    if fz is not None:
        rows = torch.where(_cm_flat(keep), rows, DEC_SKIP)
    return _dec_plane(data, rows, dec_table, carry, lanes)


def _launch_staging(packed, enc_table, n_y_rows, qp, c_z, mw, cap,
                    survivors=None):
    """K1 over a frame's operand against its combined [y rows | qp's z
    rows] slice of the prepared encode table, compacted on the device:
    the (cap + 3L) int32 staging of u16 values (densify_segment), with the
    survivor count's two words after it under skip compaction.  Returns
    without waiting for the device."""
    z_base = n_y_rows + qp * c_z
    comb = torch.cat([enc_table[:n_y_rows],
                      enc_table[z_base:z_base + c_z]])
    return densify_segment(*encode_scan(packed, comb, mw), cap, survivors)


def _launcher(operand, enc_table, n_y_rows, qp, c_z):
    """launch(mw, cap, kyc): K1 over a frame's operand (`operand(kyc)` ->
    (packed, survivors), a partial of _pack_frame) at the rung (mw, cap)
    and compaction rung kyc; returns the staging on the device."""
    def launch(mw, cap, kyc):
        packed, survivors = operand(kyc)
        return _launch_staging(packed, enc_table, n_y_rows, qp, c_z, mw,
                               cap, survivors)
    return launch


def _settle(net, arr, key, plan, bps, rerun):
    """settle_staging for a DMC or DMCI codec `net`: serialize a fetched
    staging launched by the StagingPlan `plan` at `bps` bytes per symbol
    (`rerun(mw, cap, kyc)` re-runs the frame at a grown rung and returns
    its host staging), count the reruns in the trace's `ec.rerun` and
    learn the settled rate for the frame size `key` in net._ec_learned.
    Takes net._ec_lock for that, so chunks may settle on several
    threads."""
    stream, g_bps, reruns = settle_staging(
        arr, plan, functools.partial(net._rung, plan.lanes), bps,
        net.bytes_per_symbol, rerun)
    if reruns:
        trace.count("ec.rerun", reruns)
    with net._ec_lock:
        if g_bps > max(bps, net._ec_learned.get(key, 0.0)):
            net._ec_learned[key] = g_bps
    return stream


# ---------------------------------------------------------------------------
# host-EC layout: the host coder takes planes flattened NHWC
# ---------------------------------------------------------------------------

def _pack_host(z_int8, planes, fz):
    """A frame's C.pack_host buffer: z, each y plane packed (symbol << 8) +
    CDF index, then, with force_zero_thres, each y plane's keep mask."""
    return C.pack_host([z_int8], [sym * 256 + idx.to(torch.int32)
                                  for sym, idx, _ in planes],
                       None if fz is None else [k for _, _, k in planes])


# ---------------------------------------------------------------------------
# per-frame encoder and decoder
# ---------------------------------------------------------------------------

def _encode_stages(p, x, feature, qp, fz=None):
    """Encoder body on an adapted feature: frame -> (next reference
    feature, z int8, [(symbols, indexes, keep) of y0, of y1])."""
    x1, ctx_t = _stage_fe_part1(p, feature, qp)
    ctx = _stage_fe_part2(p, x1)
    y, z_hat, z_int8 = _stage_encode_y(p, x, ctx, qp)
    params_prior = _stage_prior(p, z_hat, ctx_t)
    y_div, sym0, idx0, keep0, y_hat_0 = _stage_enc_pass0(y, params_prior,
                                                         fz)
    scales1, means1 = _stage_spatial(p, y_hat_0, params_prior)
    sym1, idx1, keep1, y_hat_1 = _stage_enc_pass1(y_div, scales1, means1,
                                                  fz)
    feature_out = _stage_feature_out(p, y_hat_0, y_hat_1, params_prior,
                                     ctx, qp)
    return feature_out, z_int8, [(sym0, idx0, keep0), (sym1, idx1, keep1)]


def _operand(planes, z_int8, lanes, n_y_rows, fz, kyc):
    """A frame's K1 operand as a callable of the compaction rung:
    operand(k) -> (packed, survivors), packed at once at the first rung
    kyc and again only when a rerun changes the rung."""
    first = _pack_frame(planes, z_int8, lanes, n_y_rows, fz, kyc)
    return lambda k: first if k == kyc else _pack_frame(
        planes, z_int8, lanes, n_y_rows, fz, k)


def _compress_frame_core(p, x, feature, qp, lanes, n_y_rows, fz=None,
                         kyc=0):
    """Device-EC encoder body: frame -> (next reference feature, the K1
    operand, `_operand`'s callable of the compaction rung, first kyc).
    Encode order per lane is reversed(y1), reversed(y0), reversed(z); the
    decoder consumes z, y0, y1."""
    feature_out, z_int8, planes = _encode_stages(p, x, feature, qp, fz)
    return feature_out, _operand(planes[::-1], z_int8, lanes, n_y_rows, fz,
                                 kyc)


def _compress_gop(p, xs, feature_in, qps, lanes, n_y_rows, enc_table, mw,
                  cap, fz=None, kyc=0):
    """GOP encoder: N consecutive P-frames with the propagated feature
    carried from frame to frame (the JAX package's `_compress_gop` scan).
    Each frame runs the single-frame path's B=1 stages
    (`_stage_adaptor_p`, then `_compress_frame_core`) and one K1 launch at
    the rung (mw, cap, kyc): no NN stage sees a batch dimension, so every
    frame's floats, and so its symbols, are the single-frame path's.
    xs: N NCHW frames; qps: N ints.

    Returns (feature_last, stagings (N, cap + 3L, + 2 with kyc > 0) int32
    u16 values,
    feats_in: frame i's carry-in feature, from which an overflowing frame
    re-runs alone)."""
    feat, segs, feats_in = feature_in, [], []
    for x, qp in zip(xs, qps):
        feats_in.append(feat)
        feat, operand = _compress_frame_core(
            p, x, _stage_adaptor_p(p, feat), qp, lanes, n_y_rows, fz, kyc)
        segs.append(_launcher(operand, enc_table, n_y_rows, qp, G_CH_Z)(
            mw, cap, kyc))
    return feat, torch.stack(segs), feats_in


def _z_table(dec_table, n_y_rows, qp):
    """qp's G_CH_Z z rows of a prepared table: a slice for an int qp, a
    gather for a (1,) int64 tensor on the table's device (no host
    read)."""
    if not isinstance(qp, torch.Tensor):
        z_base = n_y_rows + qp * G_CH_Z
        return dec_table[z_base:z_base + G_CH_Z]
    rows = torch.arange(G_CH_Z, device=qp.device) + (n_y_rows
                                                      + qp * G_CH_Z)
    return dec_table.index_select(0, rows)


def _decompress_frame_core(p, staging, feature, qp, dec_table, n_y_rows,
                           zh, zw, lanes, cap, mw, fz=None, kyc=0):
    """Decoder body on an adapted feature: compact staging -> (next
    reference feature, x_hat NCHW).  The three K2 launches share one rANS
    state/pointer carry and read row slices of the prepared decode table;
    every shared stage is the code the encoder ran.  qp is an int or a
    (1,) int64 tensor on the device (`C.q_vec`, `_z_table`): the same
    rows either way."""
    x1, ctx_t = _stage_fe_part1(p, feature, qp)
    data, states = _undensify_device(staging, cap, lanes, mw)
    carry = (states, torch.zeros((lanes,), dtype=torch.int32,
                                 device=data.device))
    n_z = zh * zw * G_CH_Z
    z_syms, carry = _dec_plane(data, _z_rows(n_z, G_CH_Z, data.device),
                               _z_table(dec_table, n_y_rows, qp), carry,
                               lanes)
    z_hat = _cm_unflat(z_syms, (1, G_CH_Z, zh, zw)).to(x1.dtype)
    params_prior = _stage_prior(p, z_hat, ctx_t)

    dec_y = dec_table[:n_y_rows]
    idx0, keep0 = _stage_dec_index0(params_prior, fz)
    ctx = _stage_fe_part2(p, x1)
    y0_syms, carry = _dec_y_plane(data, idx0, keep0, dec_y, carry, lanes,
                                  fz, kyc)
    means0 = C.separate_prior_video_decoding(params_prior)[2]
    y_hat_0 = _stage_dec_restore_2x(
        _cm_unflat(y0_syms, idx0.shape).to(x1.dtype), means0, 0)

    scales1, means1 = _stage_spatial(p, y_hat_0, params_prior)
    idx1, keep1 = _stage_fold_index_2x(scales1, 1, fz)
    y1_syms, carry = _dec_y_plane(data, idx1, keep1, dec_y, carry, lanes,
                                  fz, kyc)
    y_hat_1 = _stage_dec_restore_2x(
        _cm_unflat(y1_syms, idx1.shape).to(x1.dtype), means1, 1)

    feature_out = _stage_feature_out(p, y_hat_0, y_hat_1, params_prior,
                                     ctx, qp)
    return feature_out, _stage_recon_x(p, feature_out, qp)


# ---------------------------------------------------------------------------
# DPB
# ---------------------------------------------------------------------------

class RefFrame:
    """One decoded-picture-buffer entry: `frame` is an NHWC pixel frame,
    `feature` the propagated feature (NCHW)."""

    def __init__(self):
        self.frame = None
        self.feature = None
        self.poc = None


# ---------------------------------------------------------------------------
# host orchestrator
# ---------------------------------------------------------------------------

class DMC:
    """DCVC-RT P-frame codec.

    device_ec: code the symbols on the device (K1/K2, the "tpu-lane"
    container) instead of with the host coder (the default, as in the JAX
    package without OPENDCVC_TPU_DEVICE_EC).  lanes, bytes_per_symbol and
    cap_frac size the device-EC lane rANS staging; each one not given is
    read, as the JAX package reads it, from OPENDCVC_TPU_EC_LANES /
    _EC_BPS / _EC_CAP_FRAC (defaults 4096, 0.5, 0.5).  Skip compaction
    under force_zero_thres is on when OPENDCVC_TPU_EC_SKIP_COMPACT is set,
    its first rung's survivor share OPENDCVC_TPU_EC_SKIP_FRAC (default
    0.5; `_kyc_for`), the JAX package's knobs.

    Device EC also codes GOPs: `compress_gop(_async)` and
    `decompress_gop` / `upload_gop` + `decompress_gop_uploaded` run N
    consecutive P-frames through the single-frame path's stages with one
    device->host copy (encode) or one upload (decode) for the chunk, and
    write and read the single-frame path's streams.

    dtype: the activations' dtype (float32 or torch.bfloat16), as the JAX
    package's `DMC(dtype=)`.  Input frames are cast to it; init_params
    casts the float32 init to it; load_params keeps the loaded dtypes and
    each convolution and qp bank is cast to the activations' dtype where
    it is used.  The DPB holds frames and features in it."""

    def __init__(self, device="cuda", device_ec=False, lanes=None,
                 bytes_per_symbol=None, cap_frac=None, dtype=torch.float32):
        self.device = C.resolve_device(device)
        self.device_ec = device_ec
        self.dtype = dtype
        self.lanes = C.ec_setting(lanes, "OPENDCVC_TPU_EC_LANES", 4096)
        self.bytes_per_symbol = C.ec_setting(
            bytes_per_symbol, "OPENDCVC_TPU_EC_BPS", 0.5)
        self.cap_frac = C.ec_setting(cap_frac, "OPENDCVC_TPU_EC_CAP_FRAC",
                                     0.5)
        self.skip_compact = env_flag("OPENDCVC_TPU_EC_SKIP_COMPACT")
        self.skip_frac = C.ec_setting(None, "OPENDCVC_TPU_EC_SKIP_FRAC", 0.5)
        self.qp_shift = QP_SHIFT
        self.params = None
        self.bit_estimator_z = BitEstimator(C.QP_NUM + EXTRA_QP, G_CH_Z)
        self.gaussian_encoder = GaussianEncoder()
        self.force_zero_thres = None
        self.entropy_coder = None
        self.enc_table = None
        self.dec_table = None
        self.n_y_rows = 0
        # qp ids on the device: the decoder body takes its qp as a (1,)
        # slice of them, so one CUDA graph serves every qp
        self._qp_ids = None

        self.dpb = []
        self.max_dpb_size = 1
        self.curr_poc = 0
        # learned launch staging rate (bytes/symbol) per (H, W): content
        # hotter than the first-rung guess pays the regrow ladder once
        self._ec_learned = {}
        self._ec_lock = threading.Lock()
        # the encode copy's window for each staging capacity
        # (entropy/device_rans.py::slim_fetch)
        self._fetch_windows = {}
        # the device-EC decoder body's CUDA graphs, dropped whenever the
        # weights or the tables they read by address change
        self._graphs = BodyGraphs()

    # -- setup ---------------------------------------------------------------

    def init_params(self, seed=0):
        """Draw in float32, then cast the float32 leaves to the codec's
        dtype."""
        gen = torch.Generator().manual_seed(seed)
        self.params = to_device(cast_floating(dmc_init(gen), self.dtype),
                                self.device)
        self._graphs.clear()
        return self.params

    def load_params(self, params):
        self.params = to_device(params, self.device)
        self._graphs.clear()

    def update(self, force_zero_thres=None):
        """Build the CDF tables.  Host EC: register them with a new host
        coder (group 0 the gaussian scale rows, group 1 the z rows by qp,
        channel).  Device EC: rows [0, n_y) are the gaussian scale rows,
        rows n_y + qp * 128 + channel the z rows; K1 and K2 read slices of
        their prepared forms, `enc_table` and `dec_table`.  Drops the
        decoder's CUDA graphs, which read the weights and tables by
        address, so the next decode reads those set before this call."""
        self.force_zero_thres = force_zero_thres
        self._graphs.clear()
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
        self._qp_ids = torch.arange(C.QP_NUM + EXTRA_QP, device=self.device)

    def set_use_two_entropy_coders(self, b):
        """Split each plane between two host coders (the harness's choice
        above 1280x720); no effect with device EC."""
        if self.entropy_coder is not None:
            self.entropy_coder.set_use_two_entropy_coders(b)

    # -- DPB management ------------------------------------------------------

    def reset_ref_feature(self):
        if self.dpb:
            self.dpb[0].feature = None

    def add_ref_frame(self, feature=None, frame=None, increase_poc=True):
        """frame: NHWC pixel frame; feature: a feature this codec made."""
        ref = RefFrame()
        ref.poc = self.curr_poc
        ref.frame = frame
        ref.feature = feature
        if len(self.dpb) >= self.max_dpb_size:
            self.dpb.pop(-1)
        self.dpb.insert(0, ref)
        if increase_poc:
            self.curr_poc += 1

    def clear_dpb(self):
        self.dpb.clear()

    def set_curr_poc(self, poc):
        self.curr_poc = poc

    def apply_feature_adaptor(self):
        if self.dpb[0].feature is None:
            return _stage_adaptor_i(
                self.params, C.frame_to_nchw(self.dpb[0].frame, self.device,
                                             self.dtype))
        return _stage_adaptor_p(self.params, self.dpb[0].feature)

    def prepare_feature_adaptor_i(self, last_qp):
        """Periodic refresh: regenerate a pixel reference from the feature
        so decoder and encoder re-anchor."""
        if self.dpb[0].frame is None:
            self.dpb[0].frame = C.frame_to_nhwc(_stage_recon_x(
                self.params, self.dpb[0].feature, last_qp))
            self.reset_ref_feature()

    def shift_qp(self, qp, fa_idx):
        return qp + self.qp_shift[fa_idx]

    # -- device-EC planning ------------------------------------------------

    def _plan_device_ec(self, H, W):
        """The StagingPlan of a frame size: lane count (scaled to the
        symbol count), steps a lane of z and of each y plane, and the
        first skip-compaction rung."""
        n_y = (H // 16) * (W // 16) * G_CH_Y // 2
        zh, zw = C.get_downsampled_shape(H, W, 64)
        n_z = zh * zw * G_CH_Z
        lanes = effective_lanes(self.lanes, 2 * n_y + n_z)
        k_y = -(-n_y // lanes)
        return StagingPlan(lanes, -(-n_z // lanes), k_y, 2,
                           _kyc_for(k_y, self.force_zero_thres,
                                    self.skip_compact, self.skip_frac))

    def _rung(self, lanes, k_total, bps):
        """(mw, cap) of the staging ladder at `bps` bytes per symbol.  The
        dense-payload budget cap is a fixed fraction of the staging
        rectangle (the strided layout keeps the longest lane near the
        mean); at the top rung (bps 3.0) it is the whole rectangle, where
        everything fits, since a symbol emits at most one word."""
        mw = staging_width(k_total, bps)
        if bps >= 3.0:
            return mw, lanes * mw
        return mw, max(4096, int(lanes * mw * self.cap_frac) // 8 * 8)

    # -- compress ------------------------------------------------------------

    def compress_async(self, x, qp):
        """Encode one P-frame (NHWC (1, H, W, 3)) against the DPB: queues
        the stages and starts the symbols' way to the coder, advances the
        DPB, and returns a zero-argument callable that returns the bit
        stream.  Host EC: one copy of every plane (and the skip masks) to
        the host, coded in the callable.  Device EC: the K1 launch and the
        start of its staging's copy, neither waited on; the callable waits
        for the copy and settles the staging ladder."""
        with trace.span("dmc.compress", 1):
            x = C.frame_to_nchw(x, self.device, self.dtype)
            if not self.device_ec:
                return self._compress_async_host(x, qp)
            H, W = x.shape[2], x.shape[3]
            plan = self._plan_device_ec(H, W)
            bps = max(self.bytes_per_symbol,
                      self._ec_learned.get((H, W), 0.0))
            feature_out, operand = _compress_frame_core(
                self.params, x, self.apply_feature_adaptor(), qp, plan.lanes,
                self.n_y_rows, self.force_zero_thres, plan.kyc)
            launch = _launcher(operand, self.enc_table, self.n_y_rows, qp,
                               G_CH_Z)
            mw, cap = self._rung(plan.lanes, plan.steps(), bps)
            fetch = slim_fetch(self._fetch_windows,
                               launch(mw, cap, plan.kyc), plan.lanes, cap)
            self.add_ref_frame(feature_out, None)
            ids = trace.frame_ids()

        def finish():
            with trace.span("dmc.finish", ids):
                return _settle(self, fetch(), (H, W), plan, bps,
                               lambda mw, cap, kyc: fetch_staging(
                                   launch(mw, cap, kyc))())

        return finish

    def _compress_async_host(self, x, qp):
        fz = self.force_zero_thres
        feature_out, z_int8, planes = _encode_stages(
            self.params, x, self.apply_feature_adaptor(), qp, fz)
        n_z, n_y = z_int8.numel(), planes[0][0].numel()
        fetch = fetch_async(_pack_host(z_int8, planes, fz))
        self.add_ref_frame(feature_out, None)
        ids = trace.frame_ids()

        def finish():
            with trace.span("dmc.finish", ids):
                return C.code_host(self.entropy_coder,
                                   [(self.bit_estimator_z, qp)],
                                   self.gaussian_encoder, fetch(), [n_z],
                                   [n_y] * len(planes), fz is not None)

        return finish

    def compress(self, x, qp):
        return {"bit_stream": self.compress_async(x, qp)()}

    def _check_gop(self, what):
        if not self.device_ec:
            raise ValueError(f"{what} requires device-EC mode")
        if not self.dpb or self.dpb[0].feature is None:
            raise ValueError(f"{what} needs a feature reference (code the "
                             "first P-frame after an I-frame alone)")

    def compress_gop_async(self, frames, qps):
        """GOP encode (device EC): N consecutive P-frames (each NHWC (1, H,
        W, 3)) at `qps` (N ints) against the DPB's feature.  Queues every
        frame's stages and K1 launch, starts ONE device->host copy of the
        N stagings, advances the DPB past the chunk, and returns a
        zero-argument callable that returns the N bit streams, each the
        stream compress() writes for that frame.  The callable may run on
        another thread while the caller queues the next chunk: a frame
        whose staging overflowed re-runs alone from its carry-in feature,
        leaving the DPB as it is."""
        self._check_gop("compress_gop_async")
        p, fz = self.params, self.force_zero_thres
        qps = [int(q) for q in qps]
        with trace.span("dmc.compress_gop", len(frames)):
            xs = [C.frame_to_nchw(x, self.device, self.dtype)
                  for x in frames]
            H, W = xs[0].shape[2], xs[0].shape[3]
            plan = self._plan_device_ec(H, W)
            bps = max(self.bytes_per_symbol,
                      self._ec_learned.get((H, W), 0.0))
            mw, cap = self._rung(plan.lanes, plan.steps(), bps)
            feat_last, stagings, feats_in = _compress_gop(
                p, xs, self.dpb[0].feature, qps, plan.lanes, self.n_y_rows,
                self.enc_table, mw, cap, fz, plan.kyc)
            fetch = slim_fetch(self._fetch_windows, stagings, plan.lanes,
                               cap)
            self.add_ref_frame(feat_last, None, increase_poc=False)
            self.curr_poc += len(xs)
            ids = trace.frame_ids()

        def rerun(i, mw, cap, kyc):
            _, operand = _compress_frame_core(
                p, xs[i], _stage_adaptor_p(p, feats_in[i]), qps[i],
                plan.lanes, self.n_y_rows, fz, kyc)
            return fetch_staging(_launcher(
                operand, self.enc_table, self.n_y_rows, qps[i], G_CH_Z)(
                    mw, cap, kyc))()

        def finish():
            with trace.span("dmc.finish", ids):
                arr = fetch()
                return [_settle(self, arr[i], (H, W), plan, bps,
                                functools.partial(rerun, i))
                        for i in range(len(xs))]

        return finish

    def compress_gop(self, frames, qps):
        return {"bit_streams": self.compress_gop_async(frames, qps)()}

    # -- decompress ----------------------------------------------------------

    @staticmethod
    def _x_hats(n, feature):
        """An (n, 1, H, W, 3) NHWC buffer for n frames decoded from
        features like `feature` ((1, C, H / 8, W / 8): H and W padded, not
        the sps's picture size)."""
        _, _, h, w = feature.shape
        return feature.new_empty((n, 1, 8 * h, 8 * w, 3))

    def _decode_staged(self, meta, staging, feature, sps, qp, x_out):
        """Device-EC decoder body on an adapted feature and an uploaded
        staging: writes x_hat into `x_out` (NHWC (1, H, W, 3)) and returns
        the next reference feature, a tensor of its own.  On a card it
        replays from the CUDA graph of its key: the frame size, the
        container's (L, MW, cap, kyc), force_zero_thres, dtype and device
        (utils/graph.py).  qp is an input of the graph, a (1,) slice of
        the device's qp ids, so frames at any qps share one graph."""
        h, w = sps["height"], sps["width"]
        zh, zw = C.get_downsampled_shape(h, w, 64)
        fz = self.force_zero_thres
        lanes, mw, cap, kyc = meta["L"], meta["MW"], meta["cap"], meta["kyc"]

        def body(staging, feature, qp):
            return _decompress_frame_core(
                self.params, staging, feature, qp, self.dec_table,
                self.n_y_rows, zh, zw, lanes, cap, mw, fz, kyc)

        key = (feature.dtype, feature.device, h, w, lanes, mw, cap, kyc, fz)
        return self._graphs.run(
            key, body, (staging, feature, self._qp_ids[qp].reshape(1)),
            self.params, (None, x_out.permute(0, 3, 1, 2)))[0]

    def _decompress_device(self, bit_stream, sps, qp):
        metas, stagings = upload_stagings([bit_stream], self.device)
        feature = self.apply_feature_adaptor()
        x_hat = self._x_hats(1, feature)[0]
        return self._decode_staged(metas[0], stagings[0], feature, sps, qp,
                                   x_hat), x_hat

    @trace.spanned("dmc.upload_gop")
    def upload_gop(self, bit_streams, sps):
        """Parse a chunk's device-EC streams and start their upload (one
        pinned, non-blocking copy), so a decoder can upload chunk k + 1
        while the device decodes chunk k.  Returns a handle for
        decompress_gop_uploaded, or None when the chunk mixes ladder rungs
        and takes the per-frame fallback."""
        metas, stagings = upload_stagings(bit_streams, self.device)
        if stagings is None:
            return None
        return metas[0], stagings, len(bit_streams)

    def decompress_gop_uploaded(self, uploaded, sps, qps):
        """Decode an upload_gop chunk at `qps` against the DPB's feature:
        each frame runs the single-frame decoder's stages (`_decode_staged`,
        a graph's replay on a card).  Returns
        {"x_hat": (N, 1, H, W, 3)} NHWC; the DPB ends at the last frame's
        (feature, x_hat)."""
        self._check_gop("decompress_gop_uploaded")
        meta, stagings, n = uploaded
        if len(qps) != n:
            raise ValueError(f"{len(qps)} qps for a chunk of {n} frames")
        with trace.span("dmc.decompress_gop", n):
            feat = self.dpb[0].feature
            x_hats = self._x_hats(n, feat)
            for staging, qp, x_hat in zip(stagings, qps, x_hats):
                feat = self._decode_staged(
                    meta, staging, _stage_adaptor_p(self.params, feat), sps,
                    int(qp), x_hat)
            self.add_ref_frame(feat, x_hats[-1], increase_poc=False)
            self.curr_poc += n
            return {"x_hat": x_hats}

    def decompress_gop(self, bit_streams, sps, qps):
        """GOP decode (device EC) of N streams at `qps`; a chunk of mixed
        ladder rungs decodes frame by frame.  Returns {"x_hat": (N, 1, H,
        W, 3)} NHWC, the DPB advanced past the chunk."""
        self._check_gop("decompress_gop")
        with trace.span("dmc.decompress_gop", len(bit_streams)):
            uploaded = self.upload_gop(bit_streams, sps)
            if uploaded is None:
                return {"x_hat": torch.stack(
                    [self.decompress(s, sps, q)["x_hat"]
                     for s, q in zip(bit_streams, qps)])}
            return self.decompress_gop_uploaded(uploaded, sps, qps)

    def _decompress_host(self, bit_stream, sps, qp):
        """Host-EC decode: the host decodes z on the coder's worker thread
        while the device runs the feature extractor's first part; each y
        pass's indexes are fetched (the host waits) and its symbols
        uploaded.  A stream that is not exactly the frame's symbols raises
        ValueError.  Returns (next reference feature, x_hat NHWC)."""
        p, fz, coder = self.params, self.force_zero_thres, self.entropy_coder
        zh, zw = C.get_downsampled_shape(sps["height"], sps["width"], 64)
        coder.set_use_two_entropy_coders(sps["ec_part"] == 1)
        coder.set_stream(bit_stream)
        self.bit_estimator_z.decode_z((zh, zw), qp)
        x1, ctx_t = _stage_fe_part1(p, self.apply_feature_adaptor(), qp)
        z_hat = C.from_host_nhwc(self.bit_estimator_z.get_z((zh, zw),
                                                            np.int8),
                                 self.device, x1.dtype)
        params_prior = _stage_prior(p, z_hat, ctx_t)

        def decode_y(fetch, shape):
            return C.decode_y_host(self.gaussian_encoder, fetch, shape,
                                   self.device, x1.dtype, fz is not None)

        idx0, keep0 = _stage_dec_index0(params_prior, fz)
        fetch0 = fetch_async(C.index_buf(idx0, keep0))
        # the device runs the feature extractor's second part while the
        # host waits for the indexes and decodes y0
        ctx = _stage_fe_part2(p, x1)
        means0 = C.separate_prior_video_decoding(params_prior)[2]
        y_hat_0 = _stage_dec_restore_2x(
            decode_y(fetch0, idx0.shape), means0, 0)

        scales1, means1 = _stage_spatial(p, y_hat_0, params_prior)
        idx1, keep1 = _stage_fold_index_2x(scales1, 1, fz)
        y_hat_1 = _stage_dec_restore_2x(
            decode_y(fetch_async(C.index_buf(idx1, keep1)), idx1.shape),
            means1, 1)
        coder.check_stream_end()

        feature_out = _stage_feature_out(p, y_hat_0, y_hat_1, params_prior,
                                         ctx, qp)
        return feature_out, C.frame_to_nhwc(_stage_recon_x(p, feature_out,
                                                           qp))

    @trace.spanned("dmc.decompress", 1)
    def decompress(self, bit_stream, sps, qp):
        """Decode one P-frame; returns {"x_hat": NHWC (1, H, W, 3)}.  Host
        EC reads the coder split from sps["ec_part"]."""
        if self.device_ec:
            feature_out, x_hat = self._decompress_device(bit_stream, sps, qp)
        else:
            feature_out, x_hat = self._decompress_host(bit_stream, sps, qp)
        self.add_ref_frame(feature_out, x_hat)
        return {"x_hat": x_hat}
