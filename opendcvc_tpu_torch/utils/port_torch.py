"""Reference PyTorch state dicts -> the port's parameter trees.

Counterpart of the JAX package's `utils/port_torch.py`, with its mapper
and helper names: `port_dmci`, `port_dmc`, `port_dmc_hem`, `port_dmc_tcm`,
`port_dmc_fm`, `port_dcvc`, `port_dmc_dc` and `port_evc` take a reference
state dict (reference parameter names; torch tensors or numpy arrays as
values) and return the tree that `utils/params.py::from_jax` makes of the
JAX mapper's tree: on the CPU, each leaf a fresh contiguous tensor with
the JAX package's dtype (float64 -> float32 and int64 -> int32, as
`jnp.asarray` turns them).  The codec's `load_params` moves it to its
device.

Conv weights stay OIHW, as the reference stores them.  The leaves that
are not conv weights keep the JAX layout: a transposed convolution's
weight is the input-dilated correlation's (in/out swapped, rotated 180
degrees), SELayer Linears are (in, out), QP banks and bit-estimator
leaves drop the trailing 1x1, and a masked conv's mask is (k, k, 1, 1).
A missing key raises KeyError; keys the mapper does not read are ignored.
"""

import numpy as np
import torch

from .params import _tensor

# jnp.asarray's dtype rules with 64-bit types off
_NP_CANON = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
             np.dtype(np.uint64): np.uint32,
             np.dtype(np.complex128): np.complex64}
_TORCH_CANON = {torch.float64: torch.float32, torch.int64: torch.int32,
                torch.complex128: torch.complex64}


def _t(v):
    """A state-dict value -> a CPU tensor in the JAX package's dtype."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        return t.to(_TORCH_CANON.get(t.dtype, t.dtype))
    a = np.asarray(v)
    return _tensor(a.astype(_NP_CANON.get(a.dtype, a.dtype), copy=False))


def _fresh(t):
    """A copy with default strides that shares no storage with the
    caller's dict."""
    return t.clone(memory_format=torch.contiguous_format)


def _conv(sd, prefix):
    """torch Conv2d (O,I,kh,kw) -> {w: (O,I,kh,kw), b: (O,)}; a
    depthwise (O,1,kh,kw) weight the same."""
    return {"w": _fresh(_t(sd[prefix + ".weight"])),
            "b": _fresh(_t(sd[prefix + ".bias"]))}


def _dcb(sd, prefix, has_adaptor):
    """DepthConvBlock (reference layers.py:65-132)."""
    p = {}
    if has_adaptor:
        p["adaptor"] = _conv(sd, prefix + ".adaptor")
    p["dc1"] = _conv(sd, prefix + ".dc.0")
    p["dc_dw"] = _conv(sd, prefix + ".dc.2")
    p["dc2"] = _conv(sd, prefix + ".dc.3")
    p["ffn1"] = _conv(sd, prefix + ".ffn.0")
    p["ffn2"] = _conv(sd, prefix + ".ffn.2")
    return p


def _dcb_auto(sd, prefix):
    return _dcb(sd, prefix, prefix + ".adaptor.weight" in sd)


def _subpel(sd, prefix):
    """SubpelConv2x: conv at .conv.0."""
    return {"conv": _conv(sd, prefix + ".conv.0")}


def _rbs2(sd, prefix):
    """ResidualBlockWithStride2: .down conv + .conv DCB(shortcut)."""
    return {"down": _conv(sd, prefix + ".down"),
            "conv": _dcb_auto(sd, prefix + ".conv")}


def _rbu(sd, prefix):
    """ResidualBlockUpsample: .up SubpelConv2x + .conv DCB(shortcut)."""
    return {"up": _subpel(sd, prefix + ".up"),
            "conv": _dcb_auto(sd, prefix + ".conv")}


def _qbank(sd, name):
    return _fresh(_t(sd[name])[:, :, 0, 0])


def _bitparm(sd, prefix, final=False):
    p = {"h": _fresh(_t(sd[prefix + ".h"])[:, :, 0, 0]),
         "b": _fresh(_t(sd[prefix + ".b"])[:, :, 0, 0])}
    if not final:
        p["a"] = _fresh(_t(sd[prefix + ".a"])[:, :, 0, 0])
    return p


def _bit_estimator(sd, prefix):
    return {"f1": _bitparm(sd, prefix + ".f1"),
            "f2": _bitparm(sd, prefix + ".f2"),
            "f3": _bitparm(sd, prefix + ".f3"),
            "f4": _bitparm(sd, prefix + ".f4", final=True)}


def port_dmci(sd):
    """Reference DMCI state dict -> the port's DMCI params."""
    p = {}
    p["enc1"] = _dcb_auto(sd, "enc.enc_1")
    p["enc2"] = [_dcb_auto(sd, f"enc.enc_2.{i}") for i in range(6)]
    p["enc_down"] = _conv(sd, "enc.enc_2.6")
    p["hyper_enc"] = [
        _dcb_auto(sd, "hyper_enc.0"),
        _rbs2(sd, "hyper_enc.1"),
        _rbs2(sd, "hyper_enc.2"),
    ]
    p["hyper_dec"] = [
        _rbu(sd, "hyper_dec.0"),
        _rbu(sd, "hyper_dec.1"),
        _dcb_auto(sd, "hyper_dec.2"),
    ]
    p["y_prior_fusion"] = [
        _dcb_auto(sd, "y_prior_fusion.0"),
        _dcb_auto(sd, "y_prior_fusion.1"),
        _dcb_auto(sd, "y_prior_fusion.2"),
        _conv(sd, "y_prior_fusion.3"),
    ]
    p["reduction"] = _conv(sd, "y_spatial_prior_reduction")
    for k in (1, 2, 3):
        p[f"adaptor_{k}"] = _dcb_auto(sd, f"y_spatial_prior_adaptor_{k}")
    p["y_spatial_prior"] = [
        _dcb_auto(sd, "y_spatial_prior.0"),
        _dcb_auto(sd, "y_spatial_prior.1"),
        _dcb_auto(sd, "y_spatial_prior.2"),
        _conv(sd, "y_spatial_prior.3"),
    ]
    p["dec1_up"] = _rbu(sd, "dec.dec_1.0")
    p["dec1"] = [_dcb_auto(sd, f"dec.dec_1.{i}") for i in range(1, 13)]
    p["dec2"] = _dcb_auto(sd, "dec.dec_2")
    p["q_scale_enc"] = _qbank(sd, "q_scale_enc")
    p["q_scale_dec"] = _qbank(sd, "q_scale_dec")
    p["bit_estimator_z"] = _bit_estimator(sd, "bit_estimator_z")
    return p


# ---------------------------------------------------------------------------
# DCVC-HEM porting (reference DCVC-family/DCVC-HEM/src/models/{video_model,
# video_net}.py + src/layers/layers.py parameter names)
# ---------------------------------------------------------------------------

def _hem_spynet(sd, prefix="optic_flow"):
    return {"moduleBasic": [
        {f"c{i}": _conv(sd, f"{prefix}.moduleBasic.{j}.conv{i}")
         for i in range(1, 6)} for j in range(4)]}


def _hem_res(sd, prefix):
    """video_net ResBlock / layers ResidualBlock: conv1, conv2."""
    return {"c1": _conv(sd, prefix + ".conv1"),
            "c2": _conv(sd, prefix + ".conv2")}


def _hem_rbs(sd, prefix):
    """ResidualBlockWithStride: conv1, conv2, downsample."""
    p = {"conv1": _conv(sd, prefix + ".conv1"),
         "conv2": _conv(sd, prefix + ".conv2")}
    if prefix + ".downsample.weight" in sd:
        p["down"] = _conv(sd, prefix + ".downsample")
    return p


def _hem_rb(sd, prefix):
    """layers ResidualBlock: conv1, conv2 (+ adaptor when in != out —
    never the case in the HEM towers)."""
    return {"c1": _conv(sd, prefix + ".conv1"),
            "c2": _conv(sd, prefix + ".conv2")}


def _hem_rbu(sd, prefix):
    return {"subpel": _conv(sd, prefix + ".subpel_conv.0"),
            "conv": _conv(sd, prefix + ".conv"),
            "up": _conv(sd, prefix + ".upsample.0")}


def _hem_se(sd, prefix):
    """SELayer: two bias-free Linears; torch Linear weight is (out, in),
    the JAX layout's matmul weights are (in, out)."""
    return {"w1": _fresh(_t(sd[prefix + ".fc.0.weight"]).T),
            "w2": _fresh(_t(sd[prefix + ".fc.2.weight"]).T)}


def _hem_cbr(sd, prefix):
    """ConvBlockResidual: conv.0, conv.2, conv.3 (SELayer), up_dim."""
    return {"c1": _conv(sd, prefix + ".conv.0"),
            "c2": _conv(sd, prefix + ".conv.2"),
            "se": _hem_se(sd, prefix + ".conv.3"),
            "up_dim": _conv(sd, prefix + ".up_dim")}


def _hem_unet(sd, prefix):
    return {"conv1": _hem_cbr(sd, prefix + ".conv1"),
            "conv2": _hem_cbr(sd, prefix + ".conv2"),
            "conv3": _hem_cbr(sd, prefix + ".conv3"),
            "refine": [_hem_res(sd, f"{prefix}.context_refine.{i}")
                       for i in range(4)],
            "up3": _conv(sd, prefix + ".up3.0"),
            "up_conv3": _hem_cbr(sd, prefix + ".up_conv3"),
            "up2": _conv(sd, prefix + ".up2.0"),
            "up_conv2": _hem_cbr(sd, prefix + ".up_conv2")}


def _hem_hyper_enc(sd, prefix):
    """5-conv hyper tower (video_net.py:251-262): indices 0,2,4,6,8."""
    return [_conv(sd, f"{prefix}.{i}") for i in (0, 2, 4, 6, 8)]


def _hem_hyper_dec(sd, prefix):
    return {"c1": _conv(sd, prefix + ".0"),
            "up1": _conv(sd, prefix + ".2.0"),
            "c2": _conv(sd, prefix + ".4"),
            "up2": _conv(sd, prefix + ".6.0"),
            "c3": _conv(sd, prefix + ".8")}


def _hem_stack(sd, prefix, n=3):
    """conv+LeakyReLU(0.2) stacks: indices 0, 2, 4, ..."""
    return [_conv(sd, f"{prefix}.{2 * i}") for i in range(n)]


def _hem_vec(sd, name):
    return _fresh(_t(sd[name]).reshape(-1))


def port_dmc_hem(sd):
    """Reference DCVC-HEM video state dict -> the port's DMCHEM
    params."""
    p = {}
    p["optic_flow"] = _hem_spynet(sd)
    p["mv_encoder"] = {
        "rbs1": _hem_rbs(sd, "mv_encoder.0"),
        "rb1": _hem_rb(sd, "mv_encoder.1"),
        "rbs2": _hem_rbs(sd, "mv_encoder.2"),
        "rb2": _hem_rb(sd, "mv_encoder.3"),
        "rbs3": _hem_rbs(sd, "mv_encoder.4"),
        "rb3": _hem_rb(sd, "mv_encoder.5"),
        "down": _conv(sd, "mv_encoder.6"),
    }
    p["mv_decoder"] = {
        "rb1": _hem_rb(sd, "mv_decoder.0"),
        "rbu1": _hem_rbu(sd, "mv_decoder.1"),
        "rb2": _hem_rb(sd, "mv_decoder.2"),
        "rbu2": _hem_rbu(sd, "mv_decoder.3"),
        "rb3": _hem_rb(sd, "mv_decoder.4"),
        "rbu3": _hem_rbu(sd, "mv_decoder.5"),
        "rb4": _hem_rb(sd, "mv_decoder.6"),
        "subpel": _conv(sd, "mv_decoder.7.0"),
    }
    p["mv_hyper_enc"] = _hem_hyper_enc(sd, "mv_hyper_prior_encoder")
    p["mv_hyper_dec"] = _hem_hyper_dec(sd, "mv_hyper_prior_decoder")
    p["mv_y_prior_fusion"] = _hem_stack(sd, "mv_y_prior_fusion")
    p["mv_y_spatial_prior"] = _hem_stack(sd, "mv_y_spatial_prior")

    p["feature_adaptor_I"] = _conv(sd, "feature_adaptor_I")
    p["feature_adaptor_P"] = _conv(sd, "feature_adaptor_P")
    p["feature_extractor"] = {
        "c1": _conv(sd, "feature_extractor.conv1"),
        "r1": _hem_res(sd, "feature_extractor.res_block1"),
        "c2": _conv(sd, "feature_extractor.conv2"),
        "r2": _hem_res(sd, "feature_extractor.res_block2"),
        "c3": _conv(sd, "feature_extractor.conv3"),
        "r3": _hem_res(sd, "feature_extractor.res_block3"),
    }
    p["ctx_fusion"] = {
        "c3_up": _conv(sd, "context_fusion_net.conv3_up.0"),
        "r3_up": _hem_res(sd, "context_fusion_net.res_block3_up"),
        "c3_out": _conv(sd, "context_fusion_net.conv3_out"),
        "r3_out": _hem_res(sd, "context_fusion_net.res_block3_out"),
        "c2_up": _conv(sd, "context_fusion_net.conv2_up.0"),
        "r2_up": _hem_res(sd, "context_fusion_net.res_block2_up"),
        "c2_out": _conv(sd, "context_fusion_net.conv2_out"),
        "r2_out": _hem_res(sd, "context_fusion_net.res_block2_out"),
        "c1_out": _conv(sd, "context_fusion_net.conv1_out"),
        "r1_out": _hem_res(sd, "context_fusion_net.res_block1_out"),
    }
    p["ctx_enc"] = {
        "c1": _conv(sd, "contextual_encoder.conv1"),
        "r1": _hem_res(sd, "contextual_encoder.res1"),
        "c2": _conv(sd, "contextual_encoder.conv2"),
        "r2": _hem_res(sd, "contextual_encoder.res2"),
        "c3": _conv(sd, "contextual_encoder.conv3"),
        "c4": _conv(sd, "contextual_encoder.conv4"),
    }
    p["hyper_enc"] = [_conv(sd, f"contextual_hyper_prior_encoder.{i}")
                      for i in (0, 2, 4)]
    p["hyper_dec"] = _hem_hyper_dec(sd, "contextual_hyper_prior_decoder")
    p["temporal_prior"] = {
        "c1": _conv(sd, "temporal_prior_encoder.0"),
        "c2": _conv(sd, "temporal_prior_encoder.2"),
    }
    p["y_prior_fusion"] = _hem_stack(sd, "y_prior_fusion")
    p["y_spatial_prior"] = _hem_stack(sd, "y_spatial_prior")
    p["ctx_dec"] = {
        "up1": _conv(sd, "contextual_decoder.up1.0"),
        "up2": _conv(sd, "contextual_decoder.up2.0"),
        "r1": _hem_res(sd, "contextual_decoder.res1"),
        "up3": _conv(sd, "contextual_decoder.up3.0"),
        "r2": _hem_res(sd, "contextual_decoder.res2"),
        "up4": _conv(sd, "contextual_decoder.up4.0"),
    }
    p["recon"] = {
        "first": _conv(sd, "recon_generation_net.first_conv"),
        "unet1": _hem_unet(sd, "recon_generation_net.unet_1"),
        "unet2": _hem_unet(sd, "recon_generation_net.unet_2"),
        "head": _conv(sd, "recon_generation_net.recon_conv"),
    }
    for name in ("mv_y_q_basic", "mv_y_q_scale", "y_q_basic",
                 "y_q_scale"):
        p[name] = _hem_vec(sd, name)
    p["bit_estimator_z"] = _bit_estimator(sd, "bit_estimator_z")
    p["bit_estimator_z_mv"] = _bit_estimator(sd, "bit_estimator_z_mv")
    return p


# ---------------------------------------------------------------------------
# DCVC-TCM porting (reference DCVC-family/DCVC-TCM/src/models/
# video_net_dmc.py parameter names)
# ---------------------------------------------------------------------------

def _deconv(sd, prefix):
    """torch ConvTranspose2d (I,O,kh,kw) -> the input-dilated-conv weight
    `layers/blocks.py::conv_transpose2x_apply` takes: in/out swapped and
    rotated 180 degrees, (O,I,kh,kw)."""
    w = _t(sd[prefix + ".weight"])             # (I, O, kh, kw)
    return {"w": _fresh(w.transpose(0, 1).flip(2, 3)),
            "b": _fresh(_t(sd[prefix + ".bias"]))}


def _gdn(sd, prefix):
    """GDN: beta (C,), gamma (C_out, C_in) in torch orientation."""
    return {"beta": _fresh(_t(sd[prefix + ".beta"])),
            "gamma": _fresh(_t(sd[prefix + ".gamma"]))}


def port_dmc_tcm(sd):
    """Reference DCVC-TCM state dict -> the port's DMCTCM params."""
    p = {}
    p["optic_flow"] = _hem_spynet(sd)
    p["mv_enc"] = [
        {"conv": _conv(sd, f"mv_encoder.{4 * i}"),
         "gdn": _gdn(sd, f"mv_encoder.{4 * i + 1}"),
         "res": _hem_res(sd, f"mv_encoder.{4 * i + 2}")}
        for i in range(3)
    ] + [{"conv": _conv(sd, "mv_encoder.12")}]
    p["mv_prior_enc"] = [_conv(sd, f"mv_prior_encoder.{i}")
                         for i in (0, 2, 4)]
    p["mv_prior_dec"] = [_deconv(sd, "mv_prior_decoder.0"),
                         _deconv(sd, "mv_prior_decoder.2"),
                         _deconv(sd, "mv_prior_decoder.4")]
    p["mv_dec"] = {
        "t1": _deconv(sd, "mv_decoder.0"),
        "res": _hem_res(sd, "mv_decoder.2"),
        "gdn1": _gdn(sd, "mv_decoder.3"),
        "t2": _deconv(sd, "mv_decoder.4"),
        "gdn2": _gdn(sd, "mv_decoder.5"),
        "t3": _deconv(sd, "mv_decoder.6"),
        "gdn3": _gdn(sd, "mv_decoder.7"),
        "t4": _deconv(sd, "mv_decoder.8"),
    }
    p["feature_adaptor_I"] = _conv(sd, "feature_adaptor_I")
    p["feature_adaptor_P"] = _conv(sd, "feature_adaptor_P")
    p["feature_extractor"] = {
        "c1": _conv(sd, "feature_extractor.conv1"),
        "r1": _hem_res(sd, "feature_extractor.res_block1"),
        "c2": _conv(sd, "feature_extractor.conv2"),
        "r2": _hem_res(sd, "feature_extractor.res_block2"),
        "c3": _conv(sd, "feature_extractor.conv3"),
        "r3": _hem_res(sd, "feature_extractor.res_block3"),
    }
    p["ctx_fusion"] = {
        "c3_up": _conv(sd, "context_fusion_net.conv3_up.0"),
        "r3_up": _hem_res(sd, "context_fusion_net.res_block3_up"),
        "c3_out": _conv(sd, "context_fusion_net.conv3_out"),
        "r3_out": _hem_res(sd, "context_fusion_net.res_block3_out"),
        "c2_up": _conv(sd, "context_fusion_net.conv2_up.0"),
        "r2_up": _hem_res(sd, "context_fusion_net.res_block2_up"),
        "c2_out": _conv(sd, "context_fusion_net.conv2_out"),
        "r2_out": _hem_res(sd, "context_fusion_net.res_block2_out"),
        "c1_out": _conv(sd, "context_fusion_net.conv1_out"),
        "r1_out": _hem_res(sd, "context_fusion_net.res_block1_out"),
    }
    p["ctx_enc"] = {
        "c1": _conv(sd, "contextual_encoder.conv1"),
        "g1": _gdn(sd, "contextual_encoder.gdn1"),
        "r1": _hem_res(sd, "contextual_encoder.res1"),
        "c2": _conv(sd, "contextual_encoder.conv2"),
        "g2": _gdn(sd, "contextual_encoder.gdn2"),
        "r2": _hem_res(sd, "contextual_encoder.res2"),
        "c3": _conv(sd, "contextual_encoder.conv3"),
        "g3": _gdn(sd, "contextual_encoder.gdn3"),
        "c4": _conv(sd, "contextual_encoder.conv4"),
    }
    p["ctx_dec"] = {
        "up1": _conv(sd, "contextual_decoder.up1.0"),
        "g1": _gdn(sd, "contextual_decoder.gdn1"),
        "up2": _conv(sd, "contextual_decoder.up2.0"),
        "g2": _gdn(sd, "contextual_decoder.gdn2"),
        "r1": _hem_res(sd, "contextual_decoder.res1"),
        "up3": _conv(sd, "contextual_decoder.up3.0"),
        "g3": _gdn(sd, "contextual_decoder.gdn3"),
        "r2": _hem_res(sd, "contextual_decoder.res2"),
        "up4": _conv(sd, "contextual_decoder.up4.0"),
    }
    p["hyper_enc"] = [_conv(sd, f"contextual_hyper_prior_encoder.{i}")
                      for i in (0, 2, 4)]
    p["hyper_dec"] = [_deconv(sd, "contextual_hyper_prior_decoder.0"),
                      _deconv(sd, "contextual_hyper_prior_decoder.2"),
                      _deconv(sd, "contextual_hyper_prior_decoder.4")]
    p["temporal_prior"] = {
        "c1": _conv(sd, "temporal_prior_encoder.conv1"),
        "g1": _gdn(sd, "temporal_prior_encoder.gdn1"),
        "c2": _conv(sd, "temporal_prior_encoder.conv2"),
        "g2": _gdn(sd, "temporal_prior_encoder.gdn2"),
        "c3": _conv(sd, "temporal_prior_encoder.conv3"),
        "g3": _gdn(sd, "temporal_prior_encoder.gdn3"),
        "c4": _conv(sd, "temporal_prior_encoder.conv4"),
    }
    p["entropy_parameter"] = [
        _conv(sd, f"contextual_entropy_parameter.{i}") for i in (0, 2, 4)]
    p["recon"] = {
        "first": _conv(sd, "recon_generation_net.feature_conv.0"),
        "res1": _hem_res(sd, "recon_generation_net.feature_conv.1"),
        "res2": _hem_res(sd, "recon_generation_net.feature_conv.2"),
        "head": _conv(sd, "recon_generation_net.recon_conv"),
    }
    p["bit_estimator_z"] = _bit_estimator(sd, "bit_estimator_z")
    p["bit_estimator_z_mv"] = _bit_estimator(sd, "bit_estimator_z_mv")
    return p


# ---------------------------------------------------------------------------
# DCVC-FM porting (reference DCVC-family/DCVC-FM/src/models/{video_model,
# layers, video_net}.py parameter names)
# ---------------------------------------------------------------------------

def _fm_dc(sd, prefix):
    """FM DepthConv (FM layers.py:154-178): conv1.0, depth_conv, conv2."""
    p = {"conv1": _conv(sd, prefix + ".conv1.0"),
         "dw": _conv(sd, prefix + ".depth_conv"),
         "conv2": _conv(sd, prefix + ".conv2")}
    if prefix + ".adaptor.weight" in sd:
        p["adaptor"] = _conv(sd, prefix + ".adaptor")
    return p


def _fm_dcb(sd, prefix):
    """FM DepthConvBlock = DepthConv + ConvFFN (conv.0 / conv.2)."""
    return {"dc": _fm_dc(sd, prefix + ".block.0"),
            "ffn": {"c1": _conv(sd, prefix + ".block.1.conv.0"),
                    "c2": _conv(sd, prefix + ".block.1.conv.2")}}


def _fm_dcb4(sd, prefix):
    """FM DepthConvBlock4 = DepthConv + ConvFFN3 (conv / conv_out)."""
    return {"dc": _fm_dc(sd, prefix + ".block.0"),
            "ffn": {"c": _conv(sd, prefix + ".block.1.conv"),
                    "out": _conv(sd, prefix + ".block.1.conv_out")}}


def _fm_rbs(sd, prefix):
    """FM ResidualBlockWithStride: conv1, conv2, optional downsample."""
    p = {"conv1": _conv(sd, prefix + ".conv1"),
         "conv2": _conv(sd, prefix + ".conv2")}
    if prefix + ".downsample.weight" in sd:
        p["down"] = _conv(sd, prefix + ".downsample")
    return p


def _fm_rbu(sd, prefix):
    """FM ResidualBlockUpsample: subpel_conv.0, conv, upsample.0."""
    return {"subpel": _conv(sd, prefix + ".subpel_conv.0"),
            "conv": _conv(sd, prefix + ".conv"),
            "up": _conv(sd, prefix + ".upsample.0")}


def _fm_res(sd, prefix):
    """FM ResBlock (video_net.py:26-44): conv1, conv2."""
    return {"conv1": _conv(sd, prefix + ".conv1"),
            "conv2": _conv(sd, prefix + ".conv2")}


def _fm_unet2(sd, prefix):
    return {"conv1": _fm_dcb4(sd, prefix + ".conv1"),
            "conv2": _fm_dcb4(sd, prefix + ".conv2"),
            "conv3": _fm_dcb4(sd, prefix + ".conv3"),
            "refine": [_fm_dcb4(sd, f"{prefix}.context_refine.{i}")
                       for i in range(4)],
            "up3": _conv(sd, prefix + ".up3.0"),
            "up_conv3": _fm_dcb4(sd, prefix + ".up_conv3"),
            "up2": _conv(sd, prefix + ".up2.0"),
            "up_conv2": _fm_dcb4(sd, prefix + ".up_conv2")}


def _fm_me_basic(sd, prefix):
    return {f"c{i}": _conv(sd, f"{prefix}.conv{i}") for i in range(1, 6)}


def _fm_q2(sd, name):
    return _fresh(_t(sd[name]).reshape(2))


def port_dmc_fm(sd):
    """Reference DCVC-FM video state dict -> the port's DMCFM params."""
    p = {}
    p["optic_flow"] = {name: _fm_me_basic(sd, f"optic_flow.{name}")
                       for name in ("me_8x", "me_4x", "me_2x", "me_1x")}
    p["align"] = {"off1": _conv(sd, "align.conv_offset.0"),
                  "off2": _conv(sd, "align.conv_offset.2"),
                  "off3": _conv(sd, "align.conv_offset.4"),
                  "fusion": _conv(sd, "align.fusion")}
    p["mv_enc"] = {
        "enc1_rbs": _fm_rbs(sd, "mv_encoder.enc_1.0"),
        "enc1_dcb": _fm_dcb4(sd, "mv_encoder.enc_1.1"),
        "enc2": _fm_rbs(sd, "mv_encoder.enc_2"),
        "adaptor_0": _fm_dcb4(sd, "mv_encoder.adaptor_0"),
        "adaptor_1": _fm_dcb4(sd, "mv_encoder.adaptor_1"),
        "enc3_rbs": _fm_rbs(sd, "mv_encoder.enc_3.0"),
        "enc3_dcb": _fm_dcb4(sd, "mv_encoder.enc_3.1"),
        "enc3_down": _conv(sd, "mv_encoder.enc_3.2"),
    }
    p["mv_dec"] = {
        "dec1": [(_fm_dcb4 if i % 2 == 0 else _fm_rbu)(
            sd, f"mv_decoder.dec_1.{i}") for i in range(5)],
        "dec2": _fm_rbu(sd, "mv_decoder.dec_2"),
        "dec3_dcb": _fm_dcb4(sd, "mv_decoder.dec_3.0"),
        "dec3_subpel": _conv(sd, "mv_decoder.dec_3.1.0"),
    }
    p["mv_hyper_enc"] = {
        "dcb": _fm_dcb4(sd, "mv_hyper_prior_encoder.0"),
        "c1": _conv(sd, "mv_hyper_prior_encoder.1"),
        "c2": _conv(sd, "mv_hyper_prior_encoder.3"),
    }
    p["mv_hyper_dec"] = [
        _fm_rbu(sd, "mv_hyper_prior_decoder.0"),
        _fm_rbu(sd, "mv_hyper_prior_decoder.1"),
        _fm_dcb4(sd, "mv_hyper_prior_decoder.2"),
    ]
    p["mv_fusion_adaptor_0"] = _fm_dcb(sd, "mv_y_prior_fusion_adaptor_0")
    p["mv_fusion_adaptor_1"] = _fm_dcb(sd, "mv_y_prior_fusion_adaptor_1")
    p["mv_fusion"] = [_fm_dcb(sd, f"mv_y_prior_fusion.{i}")
                      for i in range(2)]
    for k in (1, 2, 3):
        p[f"mv_sp_adaptor_{k}"] = _conv(
            sd, f"mv_y_spatial_prior_adaptor_{k}")
    p["mv_spatial_prior"] = [_fm_dcb(sd, f"mv_y_spatial_prior.{i}")
                             for i in range(3)]

    p["feature_adaptor_I"] = _conv(sd, "feature_adaptor_I")
    p["feature_adaptor"] = [_conv(sd, f"feature_adaptor.{i}")
                            for i in range(3)]
    p["feature_extractor"] = {
        "c1": _conv(sd, "feature_extractor.conv1"),
        "r1": _fm_res(sd, "feature_extractor.res_block1"),
        "c2": _conv(sd, "feature_extractor.conv2"),
        "r2": _fm_res(sd, "feature_extractor.res_block2"),
        "c3": _conv(sd, "feature_extractor.conv3"),
        "r3": _fm_res(sd, "feature_extractor.res_block3"),
    }
    p["ctx_fusion"] = {
        "c3_up": _conv(sd, "context_fusion_net.conv3_up.0"),
        "r3_up": _fm_res(sd, "context_fusion_net.res_block3_up"),
        "c3_out": _conv(sd, "context_fusion_net.conv3_out"),
        "r3_out": _fm_res(sd, "context_fusion_net.res_block3_out"),
        "c2_up": _conv(sd, "context_fusion_net.conv2_up.0"),
        "r2_up": _fm_res(sd, "context_fusion_net.res_block2_up"),
        "c2_out": _conv(sd, "context_fusion_net.conv2_out"),
        "r2_out": _fm_res(sd, "context_fusion_net.res_block2_out"),
        "c1_out": _conv(sd, "context_fusion_net.conv1_out"),
        "r1_out": _fm_res(sd, "context_fusion_net.res_block1_out"),
    }
    p["ctx_enc"] = {
        "c1": _conv(sd, "contextual_encoder.conv1"),
        "r1": _fm_dcb4(sd, "contextual_encoder.res1"),
        "c2": _conv(sd, "contextual_encoder.conv2"),
        "r2": _fm_dcb4(sd, "contextual_encoder.res2"),
        "c3": _conv(sd, "contextual_encoder.conv3"),
        "c4": _conv(sd, "contextual_encoder.conv4"),
    }
    p["ctx_dec"] = {
        "up1": _conv(sd, "contextual_decoder.up1.0"),
        "up2": _conv(sd, "contextual_decoder.up2.0"),
        "r1": _fm_dcb4(sd, "contextual_decoder.res1"),
        "up3": _conv(sd, "contextual_decoder.up3.0"),
        "r2": _fm_dcb4(sd, "contextual_decoder.res2"),
        "up4": _conv(sd, "contextual_decoder.up4.0"),
    }
    p["recon"] = {
        "first": _conv(sd, "recon_generation_net.first_conv"),
        "unet1": _fm_unet2(sd, "recon_generation_net.unet_1"),
        "unet2": _fm_unet2(sd, "recon_generation_net.unet_2"),
        "head": _conv(sd, "recon_generation_net.recon_conv"),
    }
    p["hyper_enc"] = {
        "dcb": _fm_dcb4(sd, "contextual_hyper_prior_encoder.0"),
        "c1": _conv(sd, "contextual_hyper_prior_encoder.1"),
        "c2": _conv(sd, "contextual_hyper_prior_encoder.3"),
    }
    p["hyper_dec"] = [
        _fm_rbu(sd, "contextual_hyper_prior_decoder.0"),
        _fm_rbu(sd, "contextual_hyper_prior_decoder.1"),
        _fm_dcb4(sd, "contextual_hyper_prior_decoder.2"),
    ]
    p["temporal_prior"] = {
        "c1": _conv(sd, "temporal_prior_encoder.0"),
        "c2": _conv(sd, "temporal_prior_encoder.2"),
    }
    p["y_fusion_adaptor_0"] = _fm_dcb(sd, "y_prior_fusion_adaptor_0")
    p["y_fusion_adaptor_1"] = _fm_dcb(sd, "y_prior_fusion_adaptor_1")
    p["y_fusion"] = [_fm_dcb(sd, f"y_prior_fusion.{i}") for i in range(2)]
    for k in (1, 2, 3):
        p[f"y_sp_adaptor_{k}"] = _conv(sd, f"y_spatial_prior_adaptor_{k}")
    p["y_spatial_prior"] = [_fm_dcb(sd, f"y_spatial_prior.{i}")
                            for i in range(3)]

    for name in ("mv_y_q_enc", "mv_y_q_dec", "y_q_enc", "y_q_dec"):
        p[name] = _fm_q2(sd, name)
    p["bit_estimator_z"] = _bit_estimator(sd, "bit_estimator_z")
    p["bit_estimator_z_mv"] = _bit_estimator(sd, "bit_estimator_z_mv")
    return p


# ---------------------------------------------------------------------------
# DCVC (oldest) porting (reference DCVC-family/DCVC/src/models/DCVC_net.py
# parameter names)
# ---------------------------------------------------------------------------

def _masked_conv(sd, prefix):
    """MaskedConv2d: conv weight/bias + the causal mask buffer
    ((O,I,k,k) in torch; channel-invariant, stored (k,k,1,1) here, as
    `models/dcvc.py` reads it)."""
    p = _conv(sd, prefix)
    p["mask"] = _fresh(_t(sd[prefix + ".mask"])[0, 0][:, :, None, None])
    return p


def _dcvc_res(sd, prefix):
    """DCVC ResBlock (video_net.py:159-187): conv1, conv2, adapt_conv."""
    p = {"c1": _conv(sd, prefix + ".conv1"),
         "c2": _conv(sd, prefix + ".conv2")}
    if prefix + ".adapt_conv.weight" in sd:
        p["adapt"] = _conv(sd, prefix + ".adapt_conv")
    return p


def _dcvc_res01(sd, prefix):
    """ResBlock_LeakyReLU_0_Point_1: conv.0, conv.2."""
    return {"c1": _conv(sd, prefix + ".conv.0"),
            "c2": _conv(sd, prefix + ".conv.2")}


def port_dcvc(sd):
    """Reference DCVC_net state dict -> the port's DCVCNet params."""
    p = {}
    p["optic_flow"] = _hem_spynet(sd, "opticFlow")
    p["feature_extract"] = {"c": _conv(sd, "feature_extract.0"),
                            "res": _dcvc_res(sd, "feature_extract.1")}
    p["context_refine"] = {"res": _dcvc_res(sd, "context_refine.0"),
                           "c": _conv(sd, "context_refine.1")}
    p["mv_enc"] = {
        "convs": [_conv(sd, f"mvEncoder.{2 * i}") for i in range(4)],
        "gdns": [_gdn(sd, f"mvEncoder.{2 * i + 1}") for i in range(3)],
    }
    p["mv_dec1"] = {
        "convs": [_deconv(sd, f"mvDecoder_part1.{2 * i}")
                  for i in range(4)],
        "gdns": [_gdn(sd, f"mvDecoder_part1.{2 * i + 1}")
                 for i in range(3)],
    }
    p["mv_dec2"] = [_conv(sd, f"mvDecoder_part2.{2 * i}")
                    for i in range(7)]
    p["ctx_enc"] = {
        "convs": [_conv(sd, f"contextualEncoder.{i}")
                  for i in (0, 3, 6, 8)],
        "gdns": [_gdn(sd, f"contextualEncoder.{i}") for i in (1, 4, 7)],
        "res": [_dcvc_res01(sd, "contextualEncoder.2"),
                _dcvc_res01(sd, "contextualEncoder.5")],
    }
    p["ctx_dec1"] = {
        "subpels": [_conv(sd, f"contextualDecoder_part1.{i}.0")
                    for i in (0, 2, 5, 8)],
        "gdns": [_gdn(sd, f"contextualDecoder_part1.{i}")
                 for i in (1, 3, 6)],
        "res": [_dcvc_res01(sd, "contextualDecoder_part1.4"),
                _dcvc_res01(sd, "contextualDecoder_part1.7")],
    }
    p["ctx_dec2"] = {
        "c1": _conv(sd, "contextualDecoder_part2.0"),
        "res1": _dcvc_res(sd, "contextualDecoder_part2.1"),
        "res2": _dcvc_res(sd, "contextualDecoder_part2.2"),
        "c2": _conv(sd, "contextualDecoder_part2.3"),
    }
    p["prior_enc"] = [_conv(sd, f"priorEncoder.{i}") for i in (0, 2, 4)]
    p["prior_dec"] = [_deconv(sd, f"priorDecoder.{i}") for i in (0, 2, 4)]
    p["mv_prior_enc"] = [_conv(sd, f"mvpriorEncoder.{i}")
                         for i in (0, 2, 4)]
    p["mv_prior_dec"] = [_deconv(sd, f"mvpriorDecoder.{i}")
                         for i in (0, 2, 4)]
    p["entropy_parameters"] = [_conv(sd, f"entropy_parameters.{i}")
                               for i in (0, 2, 4)]
    p["entropy_parameters_mv"] = [_conv(sd, f"entropy_parameters_mv.{i}")
                                  for i in (0, 2, 4)]
    p["auto_regressive"] = _masked_conv(sd, "auto_regressive")
    p["auto_regressive_mv"] = _masked_conv(sd, "auto_regressive_mv")
    p["temporal_prior_enc"] = {
        "convs": [_conv(sd, f"temporalPriorEncoder.{2 * i}")
                  for i in range(4)],
        "gdns": [_gdn(sd, f"temporalPriorEncoder.{2 * i + 1}")
                 for i in range(3)],
    }
    p["bit_estimator_z"] = _bit_estimator(sd, "bitEstimator_z")
    p["bit_estimator_z_mv"] = _bit_estimator(sd, "bitEstimator_z_mv")
    return p


# ---------------------------------------------------------------------------
# DCVC-DC porting (reference DCVC-family/DCVC-DC/src/models/{video_model,
# layers, video_net}.py parameter names; DC's DepthConvBlock has the same
# sublayer names as FM's, so the _fm_* helpers apply)
# ---------------------------------------------------------------------------

def _dc_hyper_dec(sd, prefix):
    """get_hyper_enc_dec_models dec (DC video_net.py:239-250): conv,
    subpel1x1 (.2.0), conv, subpel1x1 (.6.0), conv — uniform width."""
    return {"c1": _conv(sd, prefix + ".0"),
            "up1": _conv(sd, prefix + ".2.0"),
            "c2": _conv(sd, prefix + ".4"),
            "up2": _conv(sd, prefix + ".6.0"),
            "c3": _conv(sd, prefix + ".8")}


def _dc_unet(sd, prefix):
    return {"conv1": _fm_dcb(sd, prefix + ".conv1"),
            "conv2": _fm_dcb(sd, prefix + ".conv2"),
            "conv3": _fm_dcb(sd, prefix + ".conv3"),
            "refine": [_fm_dcb(sd, f"{prefix}.context_refine.{i}")
                       for i in range(4)],
            "up3": _conv(sd, prefix + ".up3.0"),
            "up_conv3": _fm_dcb(sd, prefix + ".up_conv3"),
            "up2": _conv(sd, prefix + ".up2.0"),
            "up_conv2": _fm_dcb(sd, prefix + ".up_conv2")}


def port_dmc_dc(sd):
    """Reference DCVC-DC video state dict -> the port's DMCDC
    params."""
    p = {}
    p["optic_flow"] = _hem_spynet(sd)
    p["align"] = {"off1": _conv(sd, "align.conv_offset.0"),
                  "off2": _conv(sd, "align.conv_offset.2"),
                  "off3": _conv(sd, "align.conv_offset.4"),
                  "fusion": _conv(sd, "align.fusion")}
    p["mv_enc"] = {
        "enc1_rbs": _fm_rbs(sd, "mv_encoder.enc_1.0"),
        "enc1_dcb": _fm_dcb(sd, "mv_encoder.enc_1.1"),
        "enc2": _fm_rbs(sd, "mv_encoder.enc_2"),
        "adaptor_0": _fm_dcb(sd, "mv_encoder.adaptor_0"),
        "adaptor_1": _fm_dcb(sd, "mv_encoder.adaptor_1"),
        "enc3_rbs": _fm_rbs(sd, "mv_encoder.enc_3.0"),
        "enc3_dcb": _fm_dcb(sd, "mv_encoder.enc_3.1"),
        "enc3_down": _conv(sd, "mv_encoder.enc_3.2"),
    }
    p["mv_dec"] = {
        "dec1": [(_fm_dcb if i % 2 == 0 else _fm_rbu)(
            sd, f"mv_decoder.dec_1.{i}") for i in range(5)],
        "dec2": _fm_rbu(sd, "mv_decoder.dec_2"),
        "dec3_dcb": _fm_dcb(sd, "mv_decoder.dec_3.0"),
        "dec3_subpel": _conv(sd, "mv_decoder.dec_3.1.0"),
    }
    p["mv_hyper_enc"] = _hem_hyper_enc(sd, "mv_hyper_prior_encoder")
    p["mv_hyper_dec"] = _dc_hyper_dec(sd, "mv_hyper_prior_decoder")
    p["mv_fusion_adaptor_0"] = _fm_dcb(sd, "mv_y_prior_fusion_adaptor_0")
    p["mv_fusion_adaptor_1"] = _fm_dcb(sd, "mv_y_prior_fusion_adaptor_1")
    p["mv_fusion"] = [_fm_dcb(sd, f"mv_y_prior_fusion.{i}")
                      for i in range(2)]
    for k in (1, 2, 3):
        p[f"mv_sp_adaptor_{k}"] = _conv(
            sd, f"mv_y_spatial_prior_adaptor_{k}")
    p["mv_spatial_prior"] = [_fm_dcb(sd, f"mv_y_spatial_prior.{i}")
                             for i in range(3)]

    p["feature_adaptor_I"] = _conv(sd, "feature_adaptor_I")
    p["feature_adaptor"] = [_conv(sd, f"feature_adaptor.{i}")
                            for i in range(3)]
    p["feature_extractor"] = {
        "c1": _conv(sd, "feature_extractor.conv1"),
        "r1": _fm_res(sd, "feature_extractor.res_block1"),
        "c2": _conv(sd, "feature_extractor.conv2"),
        "r2": _fm_res(sd, "feature_extractor.res_block2"),
        "c3": _conv(sd, "feature_extractor.conv3"),
        "r3": _fm_res(sd, "feature_extractor.res_block3"),
    }
    p["ctx_fusion"] = {
        "c3_up": _conv(sd, "context_fusion_net.conv3_up.0"),
        "r3_up": _fm_res(sd, "context_fusion_net.res_block3_up"),
        "c3_out": _conv(sd, "context_fusion_net.conv3_out"),
        "r3_out": _fm_res(sd, "context_fusion_net.res_block3_out"),
        "c2_up": _conv(sd, "context_fusion_net.conv2_up.0"),
        "r2_up": _fm_res(sd, "context_fusion_net.res_block2_up"),
        "c2_out": _conv(sd, "context_fusion_net.conv2_out"),
        "r2_out": _fm_res(sd, "context_fusion_net.res_block2_out"),
        "c1_out": _conv(sd, "context_fusion_net.conv1_out"),
        "r1_out": _fm_res(sd, "context_fusion_net.res_block1_out"),
    }
    p["ctx_enc"] = {
        "c1": _conv(sd, "contextual_encoder.conv1"),
        "r1": _hem_res(sd, "contextual_encoder.res1"),
        "c2": _conv(sd, "contextual_encoder.conv2"),
        "r2": _hem_res(sd, "contextual_encoder.res2"),
        "c3": _conv(sd, "contextual_encoder.conv3"),
        "c4": _conv(sd, "contextual_encoder.conv4"),
    }
    p["ctx_dec"] = {
        "up1": _conv(sd, "contextual_decoder.up1.0"),
        "up2": _conv(sd, "contextual_decoder.up2.0"),
        "r1": _hem_res(sd, "contextual_decoder.res1"),
        "up3": _conv(sd, "contextual_decoder.up3.0"),
        "r2": _hem_res(sd, "contextual_decoder.res2"),
        "up4": _conv(sd, "contextual_decoder.up4.0"),
    }
    p["recon"] = {
        "first": _conv(sd, "recon_generation_net.first_conv"),
        "unet1": _dc_unet(sd, "recon_generation_net.unet_1"),
        "unet2": _dc_unet(sd, "recon_generation_net.unet_2"),
        "head": _conv(sd, "recon_generation_net.recon_conv"),
    }
    p["hyper_enc"] = {
        "c0": _conv(sd, "contextual_hyper_prior_encoder.0"),
        "c1": _conv(sd, "contextual_hyper_prior_encoder.2"),
        "c2": _conv(sd, "contextual_hyper_prior_encoder.4"),
    }
    p["hyper_dec"] = _dc_hyper_dec(sd, "contextual_hyper_prior_decoder")
    p["temporal_prior"] = {
        "c1": _conv(sd, "temporal_prior_encoder.0"),
        "c2": _conv(sd, "temporal_prior_encoder.2"),
    }
    p["y_fusion_adaptor_0"] = _fm_dcb(sd, "y_prior_fusion_adaptor_0")
    p["y_fusion_adaptor_1"] = _fm_dcb(sd, "y_prior_fusion_adaptor_1")
    p["y_fusion"] = [_fm_dcb(sd, f"y_prior_fusion.{i}") for i in range(2)]
    for k in (1, 2, 3):
        p[f"y_sp_adaptor_{k}"] = _conv(sd, f"y_spatial_prior_adaptor_{k}")
    p["y_spatial_prior"] = [_fm_dcb(sd, f"y_spatial_prior.{i}")
                            for i in range(3)]

    for name in ("mv_y_q_basic_enc", "mv_y_q_basic_dec", "y_q_basic_enc",
                 "y_q_basic_dec", "mv_y_q_scale_enc", "mv_y_q_scale_dec",
                 "y_q_scale_enc", "y_q_scale_dec"):
        p[name] = _hem_vec(sd, name)
    p["bit_estimator_z"] = _bit_estimator(sd, "bit_estimator_z")
    p["bit_estimator_z_mv"] = _bit_estimator(sd, "bit_estimator_z_mv")
    return p


def port_dmc(sd):
    """Reference DMC (video) state dict -> the port's DMC params."""
    p = {}
    p["feature_adaptor_i"] = _dcb_auto(sd, "feature_adaptor_i")
    p["feature_adaptor_p"] = _conv(sd, "feature_adaptor_p")
    p["fe_conv1"] = [_dcb_auto(sd, f"feature_extractor.conv1.{i}")
                     for i in range(2)]
    p["fe_conv2"] = [_dcb_auto(sd, f"feature_extractor.conv2.{i}")
                     for i in range(4)]
    p["enc_conv1"] = _conv(sd, "encoder.conv1")
    p["enc_conv2"] = [_dcb_auto(sd, f"encoder.conv2.{i}")
                      for i in range(2)]
    p["enc_conv3"] = _dcb_auto(sd, "encoder.conv3")
    p["enc_down"] = _conv(sd, "encoder.down")
    p["hyper_enc"] = [
        _dcb_auto(sd, "hyper_encoder.conv.0"),
        _rbs2(sd, "hyper_encoder.conv.1"),
        _rbs2(sd, "hyper_encoder.conv.2"),
    ]
    p["hyper_dec"] = [
        _rbu(sd, "hyper_decoder.conv.0"),
        _rbu(sd, "hyper_decoder.conv.1"),
        _dcb_auto(sd, "hyper_decoder.conv.2"),
    ]
    p["temporal_prior"] = _rbs2(sd, "temporal_prior_encoder")
    p["y_prior_fusion"] = [
        _dcb_auto(sd, "y_prior_fusion.conv.0"),
        _dcb_auto(sd, "y_prior_fusion.conv.1"),
        _dcb_auto(sd, "y_prior_fusion.conv.2"),
        _conv(sd, "y_prior_fusion.conv.3"),
    ]
    p["y_spatial_prior"] = [
        _dcb_auto(sd, "y_spatial_prior.conv.0"),
        _dcb_auto(sd, "y_spatial_prior.conv.1"),
        _conv(sd, "y_spatial_prior.conv.2"),
    ]
    p["dec_up"] = _subpel(sd, "decoder.up")
    p["dec_conv1"] = [_dcb_auto(sd, f"decoder.conv1.{i}")
                      for i in range(3)]
    p["dec_conv2"] = _conv(sd, "decoder.conv2")
    p["recon_conv"] = [_dcb_auto(sd, f"recon_generation_net.conv.{i}")
                       for i in range(4)]
    p["recon_head"] = _conv(sd, "recon_generation_net.head")
    for name in ("q_encoder", "q_decoder", "q_feature", "q_recon"):
        p[name] = _qbank(sd, name)
    p["bit_estimator_z"] = _bit_estimator(sd, "bit_estimator_z")
    return p


# ---------------------------------------------------------------------------
# EVC porting (reference DCVC-family/EVC/src/models/{image_model, layers,
# hyperprior}.py parameter names)
# ---------------------------------------------------------------------------

def _evc_dc(sd, prefix):
    """EVC main-path DepthConv (EVC layers.py:160-196): every conv is
    wrapped in a Sequential with its activation."""
    p = {"conv1": _conv(sd, prefix + ".conv1.0"),
         "dw": _conv(sd, prefix + ".depth_conv.0"),
         "conv2": _conv(sd, prefix + ".conv2.0")}
    if prefix + ".adaptor.weight" in sd:
        p["adaptor"] = _conv(sd, prefix + ".adaptor")
    return p


def _evc_dcb(sd, prefix):
    return {"dc": _evc_dc(sd, prefix + ".block.0"),
            "ffn": {"c1": _conv(sd, prefix + ".block.1.conv.0"),
                    "c2": _conv(sd, prefix + ".block.1.conv.2")}}


def _evc_hp_dc(sd, prefix):
    """Hyperprior DepthConv (EVC hyperprior.py:7-34): bare depth_conv
    and conv2."""
    p = {"conv1": _conv(sd, prefix + ".conv1.0"),
         "dw": _conv(sd, prefix + ".depth_conv"),
         "conv2": _conv(sd, prefix + ".conv2")}
    if prefix + ".adaptor.weight" in sd:
        p["adaptor"] = _conv(sd, prefix + ".adaptor")
    return p


def _evc_hp_dcb(sd, prefix):
    return {"dc": _evc_hp_dc(sd, prefix + ".block.0"),
            "ffn": {"c1": _conv(sd, prefix + ".block.1.conv.0"),
                    "c2": _conv(sd, prefix + ".block.1.conv.2")}}


def _evc_rbs(sd, prefix):
    p = {"conv1": _conv(sd, prefix + ".conv1"),
         "conv2": _conv(sd, prefix + ".conv2")}
    if prefix + ".downsample.weight" in sd:
        p["down"] = _conv(sd, prefix + ".downsample")
    return p


def _evc_rbu(sd, prefix):
    return {"subpel": _conv(sd, prefix + ".subpel_conv.0"),
            "conv": _conv(sd, prefix + ".conv"),
            "up": _conv(sd, prefix + ".upsample.0")}


def _evc_enc(sd, prefix):
    return {"rbs1": _evc_rbs(sd, f"{prefix}.0"),
            "dcb1": _evc_dcb(sd, f"{prefix}.1"),
            "rbs2": _evc_rbs(sd, f"{prefix}.2"),
            "dcb2": _evc_dcb(sd, f"{prefix}.3"),
            "rbs3": _evc_rbs(sd, f"{prefix}.4"),
            "dcb3": _evc_dcb(sd, f"{prefix}.5"),
            "down": _conv(sd, f"{prefix}.6")}


def _evc_dec(sd, prefix):
    return {"dcb1": _evc_dcb(sd, f"{prefix}.0"),
            "rbu1": _evc_rbu(sd, f"{prefix}.1"),
            "dcb2": _evc_dcb(sd, f"{prefix}.2"),
            "rbu2": _evc_rbu(sd, f"{prefix}.3"),
            "dcb3": _evc_dcb(sd, f"{prefix}.4"),
            "rbu3": _evc_rbu(sd, f"{prefix}.5"),
            "dcb4": _evc_dcb(sd, f"{prefix}.6"),
            "subpel": _conv(sd, f"{prefix}.7.0")}


def port_evc(sd):
    """Reference EVC (single-encoder variants) state dict ->
    the port's EVC params."""
    p = {}
    p["enc"] = _evc_enc(sd, "enc")
    p["dec"] = _evc_dec(sd, "dec")
    p["hyper"] = {
        "he_dcb": _evc_hp_dcb(sd, "hyper_enc.0"),
        "he_c1": _conv(sd, "hyper_enc.1"),
        "he_c2": _conv(sd, "hyper_enc.3"),
        "hd_up1": {"dcb": _evc_hp_dcb(sd, "hyper_dec.0"),
                   "subpel": _conv(sd, "hyper_dec.0.block.2")},
        "hd_up2": {"dcb": _evc_hp_dcb(sd, "hyper_dec.1"),
                   "subpel": _conv(sd, "hyper_dec.1.block.2")},
        "hd_dcb": _evc_hp_dcb(sd, "hyper_dec.2"),
        "fusion1": _evc_hp_dcb(sd, "y_prior_fusion.0"),
        "fusion2": _evc_hp_dcb(sd, "y_prior_fusion.1"),
    }
    p["y_spatial_prior"] = [_evc_hp_dcb(sd, f"y_spatial_prior.{i}")
                            for i in range(3)]
    p["q_basic"] = _hem_vec(sd, "q_basic")
    p["q_scale"] = _hem_vec(sd, "q_scale")
    p["bit_estimator_z"] = _bit_estimator(sd, "bit_estimator_z")
    return p
