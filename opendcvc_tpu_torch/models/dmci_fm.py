"""DMCIFM — the DCVC-FM intra codec (NCHW).

Counterpart of the JAX package's `models/dmci_fm.py`: gated DCB3
encoder/decoder, y N = 256 at 1/16, z 128 at 1/64, a four-pass quadtree
prior with a reduction conv and DCB2 adaptors, a UNet refinement head,
QP-banked q_scale vectors (64 x 128) and a QP-banked factorized prior for
z (support 50).  y is coded against 256 Gaussian scale levels in [0.11,
64].

Entropy coding has two modes, as in the JAX package (`device_ec`, by
default OPENDCVC_TPU_DEVICE_EC):
  * host EC (the default): the host C++ rANS coder codes the frame; the
    encoder copies z and the four packed planes to the host in one copy
    while the device runs the reconstruction; the decoder decodes z on
    the host, then fetches each pass's CDF indexes and uploads its
    symbols;
  * device EC: kernel K1 codes the four y quarters in reverse, then z,
    back to back per lane in one launch over the frame's combined table
    (the 256 y rows, then the qp's 128 z rows: 9-bit row ids), and five
    K2 launches decode z (the qp's z slice), then each quarter (the
    256-row y slice) between the stages that need it, carrying one rANS
    state per lane.  The container is the JAX package's "tpu-lane" v6
    and the staging ladder its FM one (`fm_settle_staging`).
Both write the JAX package's bytes, but for one fault of the JAX
package's device EC that the port does not copy: a scale clipped to 64
gets CDF index 255, which the JAX package's scans take for their skip
row (they code it at zero rate and decode 0), where K1/K2 code it like
any other row.  On a frame with no index 255 the device-EC streams are
the JAX package's, byte for byte.

dtype (float32 or bfloat16) is the activations' dtype, as in the JAX
package's FM codecs: the parameters stay as loaded (float32 from init,
never cast), each convolution casts its weights to its input's dtype, the
q banks are cast explicitly and the decoded symbols arrive in `dtype`.
Any other dtype raises NotImplementedError.
"""

import numpy as np
import torch

from ..entropy.coder import EntropyCoder
from ..entropy.device_rans import (_undensify_device, densify_segment,
                                   effective_lanes, fetch_staging, fm_rung,
                                   fm_settle_staging, full_range_cdf_rows,
                                   slim_fetch, upload_stagings)
from ..entropy.models import (BitEstimator, GaussianEncoder,
                              bit_estimator_init)
from ..layers import blocks_fm as FM
from ..layers.blocks import conv_apply, conv_init
from ..ops import fused as F
from ..ops.lane_rans import (encode_scan, pack_operand, prepare_decode_table,
                             prepare_encode_table)
from ..utils import trace
from ..utils.common import env_flag
from ..utils.params import to_device
from . import common as C
from .dmc import _dec_plane, _lane_layout_t, _z_rows
from .prior_stages import make_pass_stages

QP_NUM = 64
N = 256       # y channels
Z_CH = 128    # z channels


def fm_device_ec(device_ec):
    """An FM codec's coder: `device_ec` when the caller gives it, else
    OPENDCVC_TPU_DEVICE_EC, which the JAX package's FM constructors
    read."""
    return env_flag("OPENDCVC_TPU_DEVICE_EC") if device_ec is None \
        else bool(device_ec)


def gaussian_cfg(ge):
    """The index-building constants of a GaussianEncoder, as
    make_pass_stages takes them."""
    return (ge.SCALE_MIN, ge.SCALE_MAX, float(np.log(ge.SCALE_MIN)),
            ge.log_step_recip)


def dmci_fm_init(gen):
    p = {}
    p["enc1"] = [FM.rbs2_init(gen, 3, 128), FM.dcb3_init(gen, 128, 128)]
    p["enc2"] = {
        "rbs1": FM.rbs2_init(gen, 128, 192),
        "dcb1": FM.dcb3_init(gen, 192, 192),
        "rbs2": FM.rbs2_init(gen, 192, N),
        "dcb2": FM.dcb3_init(gen, N, N),
        "down": conv_init(gen, N, N, 3),
    }
    p["hyper_enc"] = {
        "dcb": FM.dcb4_init(gen, N, Z_CH),
        "c1": conv_init(gen, Z_CH, Z_CH, 3),
        "c2": conv_init(gen, Z_CH, Z_CH, 3),
    }
    p["hyper_dec"] = [FM.res_block_upsample_init(gen, Z_CH, Z_CH),
                      FM.res_block_upsample_init(gen, Z_CH, Z_CH),
                      FM.dcb4_init(gen, Z_CH, N)]
    p["y_fusion"] = [FM.dcb4_init(gen, N, N * 2),
                     FM.dcb4_init(gen, N * 2, N * 2 + 2)]
    p["reduction"] = conv_init(gen, N * 2 + 2, N, 1)
    for k in (1, 2, 3):
        p[f"adaptor_{k}"] = FM.dcb2_init(gen, N * 2, N * 2)
    p["y_spatial_prior"] = [FM.dcb2_init(gen, N * 2, N * 2)
                            for _ in range(3)]
    p["dec1"] = {
        "dcb1": FM.dcb3_init(gen, N, N),
        "rbu1": FM.res_block_upsample_init(gen, N, N),
        "dcb2": FM.dcb3_init(gen, N, N),
        "rbu2": FM.res_block_upsample_init(gen, N, 192),
        "dcb3": FM.dcb3_init(gen, 192, 192),
        "rbu3": FM.res_block_upsample_init(gen, 192, 128),
    }
    p["dec2"] = {
        "dcb": FM.dcb3_init(gen, 128, 128),
        "rbu": FM.res_block_upsample_init(gen, 128, 16),
    }
    p["refine_unet"] = FM.unet_init(gen, 16, 16)
    p["refine_head"] = conv_init(gen, 16, 3, 3)
    p["q_scale_enc"] = torch.ones((QP_NUM, 128))
    p["q_scale_dec"] = torch.ones((QP_NUM, 128))
    p["bit_estimator_z"] = bit_estimator_init(gen, QP_NUM, Z_CH)
    return p


# ---------------------------------------------------------------------------
# sub-networks and stages
# ---------------------------------------------------------------------------

def intra_encoder(p, x, q_enc):
    out = FM.rbs2_apply(p["enc1"][0], x)
    out = FM.dcb3_apply(p["enc1"][1], out) * q_enc
    e = p["enc2"]
    out = FM.dcb3_apply(e["dcb1"], FM.rbs2_apply(e["rbs1"], out))
    out = FM.dcb3_apply(e["dcb2"], FM.rbs2_apply(e["rbs2"], out))
    return conv_apply(e["down"], out, stride=2, padding=1)


def intra_decoder(p, y_hat, q_dec):
    d = p["dec1"]
    out = FM.dcb3_apply(d["dcb1"], y_hat)
    out = FM.dcb3_apply(d["dcb2"], FM.res_block_upsample_apply(d["rbu1"],
                                                               out))
    out = FM.dcb3_apply(d["dcb3"], FM.res_block_upsample_apply(d["rbu2"],
                                                               out))
    out = FM.res_block_upsample_apply(d["rbu3"], out) * q_dec
    out = FM.dcb3_apply(p["dec2"]["dcb"], out)
    return FM.res_block_upsample_apply(p["dec2"]["rbu"], out)


def refine(p, x):
    return conv_apply(p["refine_head"], FM.unet_apply(p["refine_unet"], x),
                      padding=1)


def hyper_enc_apply(hp, y_pad):
    out = FM.dcb4_apply(hp["dcb"], y_pad)
    out = FM.lrelu(conv_apply(hp["c1"], out, stride=2, padding=1), 0.01)
    return conv_apply(hp["c2"], out, stride=2, padding=1)


@trace.spanned("nn.enc_front")
def _stage_enc_front(p, x, qp):
    """Encoder-only: frame -> y, rounded z."""
    y = intra_encoder(p, x, C.q_vec(p["q_scale_enc"], qp, x.dtype))
    z = hyper_enc_apply(p["hyper_enc"], C.pad_for_y(y))
    z_hat, z_int8 = F.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


@trace.spanned("nn.prior")
def _stage_prior(p, z_hat, y_h, y_w):
    """Shared: z_hat -> separated prior + reduced context."""
    params = FM.res_block_upsample_apply(p["hyper_dec"][0], z_hat)
    params = FM.res_block_upsample_apply(p["hyper_dec"][1], params)
    params = FM.dcb4_apply(p["hyper_dec"][2], params)
    params = FM.dcb4_apply(p["y_fusion"][0], params)
    params = FM.dcb4_apply(p["y_fusion"][1], params)
    params = params[:, :, :y_h, :y_w]
    q_enc, q_dec, scales, means = C.separate_prior_image(params)
    reduced = conv_apply(p["reduction"], params)
    return q_enc, q_dec, scales, means, reduced


@trace.spanned("nn.spatial")
def _stage_spatial(p, k, y_hat_so_far, reduced):
    """Shared: spatial-prior pass k in {1, 2, 3} -> (scales, means)."""
    h = FM.dcb2_apply(p[f"adaptor_{k}"],
                      torch.cat((y_hat_so_far, reduced), dim=1))
    for sp in p["y_spatial_prior"]:
        h = FM.dcb2_apply(sp, h)
    c = h.shape[1] // 2
    return h[:, :c], h[:, c:]


@trace.spanned("nn.recon")
def _stage_recon(p, y_hat_so_far, q_dec_prior, qp):
    """Shared: final dequant + intra decoder + refinement + clamp."""
    y_hat = y_hat_so_far * q_dec_prior
    out = intra_decoder(p, y_hat, C.q_vec(p["q_scale_dec"], qp, y_hat.dtype))
    return torch.clamp(refine(p, out), 0.0, 1.0)


def encode_stages_ifm(p, st, x, qp):
    """Frame (NCHW) -> (x_hat NCHW, z int8, [packed y0..y3 int16]); st
    the codec's make_pass_stages(cfg, 4)."""
    y, z_hat, z_int8 = _stage_enc_front(p, x, qp)
    q_enc, q_dec_prior, scales, means, reduced = _stage_prior(
        p, z_hat, y.shape[2], y.shape[3])
    y_s = y * q_enc
    packed, so_far = [], None
    for k in range(4):
        if k > 0:
            scales, means = _stage_spatial(p, k, so_far, reduced)
        pk, so_far = st["enc_pass_k"](y_s, scales, means, so_far, k)
        packed.append(pk)
    return _stage_recon(p, so_far, q_dec_prior, qp), z_int8, packed


# ---------------------------------------------------------------------------
# device EC: K1 operands and K2 planes shared with DMCFM
# ---------------------------------------------------------------------------

def y_operand(packed, lanes):
    """K1 operand of a packed y plane ((folded symbol << 8) + CDF index,
    int16, flattened channel-major): step-major, each lane's last symbol
    first, row = the CDF index into the y rows at the head of the frame's
    table; pad slots code symbol 0 on row 0, as the JAX package's lane
    layout pads them."""
    flat = packed.reshape(-1).to(torch.int32)
    return pack_operand(_lane_layout_t(flat >> 8, lanes, True),
                        _lane_layout_t(flat & 255, lanes, True))


def dec_y_plane(data, idx, dec_y, carry, lanes, dtype):
    """One K2 launch over a y pass's CDF indexes `idx` on the 256-row y
    slice: (symbols as `idx`'s shape in `dtype`, carry)."""
    flat, carry = _dec_plane(data, idx.reshape(-1).to(torch.int32), dec_y,
                             carry, lanes)
    return flat.reshape(idx.shape).to(dtype), carry


def decode_carry(bit_stream, device):
    """Upload a device-EC container and expand it on the device: (the
    (L, MW) lane words, the (state, ptr) carry, the lane count)."""
    metas, stagings = upload_stagings([bit_stream], device)
    m = metas[0]
    data, states = _undensify_device(stagings[0], m["cap"], m["L"], m["MW"])
    return data, (states, torch.zeros((m["L"],), dtype=torch.int32,
                                      device=device)), m["L"]


def launch_staging(packed, enc_table, mw, cap, windows=None, lanes=0):
    """K1 over a frame's operand, compacted on the device and its copy to
    the host started; returns the callable that waits for the host's
    u16 staging.  With the codec's `windows` (and the staging's `lanes`)
    the copy is windowed (slim_fetch); a ladder's rerun passes none and
    copies the whole staging, as the JAX package's reruns do."""
    staging = densify_segment(*encode_scan(packed, enc_table, mw), cap)
    if windows is None:
        return fetch_staging(staging)
    return slim_fetch(windows, staging, lanes, cap)


# ---------------------------------------------------------------------------
# host orchestrator
# ---------------------------------------------------------------------------

class DMCIFM:
    """DCVC-FM intra codec.

    device: torch device (default cuda; without CUDA that raises, and the
    CPU runs only when asked for).  device_ec: the coder (None reads
    OPENDCVC_TPU_DEVICE_EC, as the JAX package's constructor does; its
    largest lane count and first staging rung come from
    OPENDCVC_TPU_EC_LANES / _EC_BPS, read there too).  dtype: float32
    or bfloat16 activations (the module docstring).
    `transfers` counts the host-EC path's copies: "d2h" the fetches the
    host waits for, "h2d" the uploads; `ec_reruns` the device-EC frames'
    ladder reruns (one K1 launch each)."""

    def __init__(self, device="cuda", device_ec=None, dtype=torch.float32):
        C.check_dtype(dtype, "DMCIFM")
        self.device = C.resolve_device(device)
        self.device_ec = fm_device_ec(device_ec)
        self.dtype = dtype
        self.lanes = C.ec_setting(None, "OPENDCVC_TPU_EC_LANES", 4096)
        self.bytes_per_symbol = C.ec_setting(None, "OPENDCVC_TPU_EC_BPS", 0.5)
        self.params = None
        self.entropy_coder = None
        self.bit_estimator_z = BitEstimator(QP_NUM, Z_CH, support=50)
        self.gaussian_encoder = GaussianEncoder(
            distribution="gaussian", scale_min=0.11, scale_max=64.0,
            scale_levels=256, support=50)
        self.transfers = {"d2h": 0, "h2d": 0}
        self.ec_reruns = 0
        # the encode copy's window for each staging capacity
        self._fetch_windows = {}
        self.enc_table = self.dec_table = None
        self.n_y_rows = 0
        self._stages = make_pass_stages(gaussian_cfg(self.gaussian_encoder),
                                        4)

    def init_params(self, seed=0):
        gen = torch.Generator().manual_seed(seed)
        self.params = to_device(dmci_fm_init(gen), self.device)
        return self.params

    def load_params(self, params):
        self.params = to_device(params, self.device)

    def update(self):
        """Build the CDF tables: the gaussian scale rows, then the z rows
        by (qp, channel).  Host EC: register them with a new host coder
        (groups 0 and 1).  Device EC: K1 and K2 read slices of their
        prepared forms, `enc_table` and `dec_table` (the JAX package's
        row layout: z row n_y_rows + qp * 128 + channel)."""
        if not self.device_ec:
            self.entropy_coder = EntropyCoder()
            self.gaussian_encoder.update(self.entropy_coder)
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
        """Split each plane between two host coders (the JAX package's
        DMCIFM.set_use_two_entropy_coders).  As there, it needs update()
        first, and has no effect with device EC."""
        if self.entropy_coder is None and self.enc_table is None:
            raise RuntimeError(
                "DMCIFM.set_use_two_entropy_coders: call update() first")
        if not self.device_ec:
            self.entropy_coder.set_use_two_entropy_coders(b)

    def _mw_cap_for(self, H, W):
        """(lanes, steps a lane) of a frame: the lane count scaled to the
        symbol count, k_total = 4 ceil(n_y / L) + ceil(n_z / L) (the JAX
        package's DMCIFM._mw_cap_for; fm_rung gives each rung's mw and
        cap)."""
        y_h, y_w = C.get_downsampled_shape(H, W, 16)
        zh, zw = C.get_downsampled_shape(H, W, 64)
        n_y = y_h * y_w * N // 4
        n_z = zh * zw * Z_CH
        lanes = effective_lanes(self.lanes, 4 * n_y + n_z)
        return lanes, 4 * (-(-n_y // lanes)) + (-(-n_z // lanes))

    @trace.spanned("dmci_fm.compress", 1)
    def compress(self, x, q_index):
        """x: (1, H, W, 3) NHWC in [0, 1], H and W multiples of 16.
        Returns {"bit_stream": bytes, "x_hat": NHWC tensor}."""
        qp = int(q_index)
        x = C.frame_to_nchw(x, self.device, self.dtype)
        x_hat, z_int8, packed = encode_stages_ifm(self.params, self._stages,
                                                  x, qp)
        if self.device_ec:
            return {"bit_stream": self._code_device(x, z_int8, packed, qp),
                    "x_hat": C.frame_to_nhwc(x_hat)}
        fetch = C.fetch_async(C.pack_host([z_int8], packed))
        x_hat = C.frame_to_nhwc(x_hat)
        buf = fetch()
        self.transfers["d2h"] += 1
        stream = C.code_host(self.entropy_coder, [(self.bit_estimator_z, qp)],
                             self.gaussian_encoder, buf, [z_int8.numel()],
                             [pk.numel() for pk in packed])
        return {"bit_stream": stream, "x_hat": x_hat}

    def _code_device(self, x, z_int8, packed, qp):
        """Device EC: one K1 launch over y3..y0 then z against [y rows |
        the qp's z rows] (z pad slots on the qp's z row 0, where the JAX
        package clamps them), then the FM staging ladder."""
        lanes, k_total = self._mw_cap_for(x.shape[2], x.shape[3])
        z_sym = z_int8.reshape(-1).to(torch.int32)
        z_rows = _z_rows(z_sym.numel(), Z_CH, z_sym.device)
        operand = torch.cat(
            [y_operand(pk, lanes) for pk in packed[::-1]]
            + [pack_operand(_lane_layout_t(z_sym, lanes, True),
                            _lane_layout_t(z_rows, lanes, True)
                            + self.n_y_rows)])
        z_base = self.n_y_rows + qp * Z_CH
        table = torch.cat([self.enc_table[:self.n_y_rows],
                           self.enc_table[z_base:z_base + Z_CH]])
        mw, cap = fm_rung(lanes, k_total, self.bytes_per_symbol)
        stream, reruns = fm_settle_staging(
            launch_staging(operand, table, mw, cap, self._fetch_windows,
                           lanes)(), lanes, k_total,
            self.bytes_per_symbol,
            lambda mw, cap: launch_staging(operand, table, mw, cap)())
        self.ec_reruns += reruns
        if reruns:
            trace.count("ec.rerun", reruns)
        return stream

    @trace.spanned("dmci_fm.decompress", 1)
    def decompress(self, bit_stream, sps):
        """sps: {"height", "width", "qp"}.  Returns {"x_hat": NHWC (1, H,
        W, 3)}.  A host-EC stream that is not exactly the frame's symbols
        raises ValueError."""
        p, st, qp = self.params, self._stages, int(sps["qp"])
        zh, zw = C.get_downsampled_shape(sps["height"], sps["width"], 64)
        y_h, y_w = C.get_downsampled_shape(sps["height"], sps["width"], 16)
        if self.device_ec:
            data, carry, lanes = decode_carry(bit_stream, self.device)
            z_base = self.n_y_rows + qp * Z_CH
            z_flat, carry = _dec_plane(
                data, _z_rows(zh * zw * Z_CH, Z_CH, self.device),
                self.dec_table[z_base:z_base + Z_CH], carry, lanes)
            z_hat = z_flat.reshape(1, Z_CH, zh, zw).to(self.dtype)
            dec_y = self.dec_table[:self.n_y_rows]

            def decode(idx):
                nonlocal carry
                y, carry = dec_y_plane(data, idx, dec_y, carry, lanes,
                                       self.dtype)
                return y
        else:
            self.entropy_coder.set_stream(bit_stream)
            z_hat = C.decode_z_host(self.bit_estimator_z, qp, zh, zw,
                                    self.device, self.dtype, self.transfers)

            def decode(idx):
                return C.decode_y_host(self.gaussian_encoder,
                                       C.fetch_async(C.index_buf(idx)),
                                       idx.shape, self.device, self.dtype,
                                       self.transfers)
        _, q_dec_prior, scales, means, reduced = _stage_prior(p, z_hat, y_h,
                                                              y_w)
        so_far = None
        for k in range(4):
            if k > 0:
                scales, means = _stage_spatial(p, k, so_far, reduced)
            so_far = st["dec_restore_acc"](
                decode(st["dec_index_k"](scales, k)), means, so_far, k)
        if not self.device_ec:
            self.entropy_coder.check_stream_end()
        return {"x_hat": C.frame_to_nhwc(
            _stage_recon(p, so_far, q_dec_prior, qp))}
