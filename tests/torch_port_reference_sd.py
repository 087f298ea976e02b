"""Reference-named state dicts from parameter trees in the JAX layout.

The inverse of each mapper of `utils/port_torch.py` (either package's):
`REFERENCE_SD[model](tree)` writes the state dict that the mapper reads
back into `tree`.  `tree` is in the JAX package's layout (HWIO conv
weights; `utils/params.py::to_jax` of a port tree), its leaves numpy
arrays; the dict's values are numpy arrays in the reference's layout:
OIHW conv weights, (I, O, kh, kw) transposed-conv weights un-rotated,
(out, in) Linear weights, QP banks and bit-estimator leaves with their
trailing 1x1, the masked conv's mask broadcast to (O, I, k, k).

Imports neither JAX nor the JAX package, so `chip_smoke.py` runs it on
the card's machine.
"""

import numpy as np


def _a(x):
    return np.ascontiguousarray(np.asarray(x))


def _conv(sd, prefix, p):
    sd[prefix + ".weight"] = _a(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    sd[prefix + ".bias"] = _a(p["b"])


def _deconv(sd, prefix, p):
    w = np.asarray(p["w"])[::-1, ::-1].transpose(2, 3, 0, 1)
    sd[prefix + ".weight"] = _a(w)
    sd[prefix + ".bias"] = _a(p["b"])


def _masked_conv(sd, prefix, p):
    _conv(sd, prefix, p)
    o, i = sd[prefix + ".weight"].shape[:2]
    m = np.asarray(p["mask"])[:, :, 0, 0]
    sd[prefix + ".mask"] = _a(np.broadcast_to(m, (o, i) + m.shape))


def _x11(x):
    return _a(np.asarray(x)[:, :, None, None])


def _qbank(sd, name, x):
    sd[name] = _x11(x)


def _vec(sd, name, x):
    sd[name] = _a(np.asarray(x).reshape(1, -1, 1, 1))


def _q2(sd, name, x):
    sd[name] = _a(np.asarray(x).reshape(2, 1, 1, 1))


def _gdn(sd, prefix, p):
    sd[prefix + ".beta"] = _a(p["beta"])
    sd[prefix + ".gamma"] = _a(p["gamma"])


def _bit_estimator(sd, prefix, p):
    for f in ("f1", "f2", "f3", "f4"):
        for leaf, x in p[f].items():
            sd[f"{prefix}.{f}.{leaf}"] = _x11(x)


def _convs(sd, names, ps):
    for name, p in zip(names, ps, strict=True):
        _conv(sd, name, p)


# --- DCVC-RT (DMCI, DMC) ----------------------------------------------------

def _dcb(sd, prefix, p):
    if "adaptor" in p:
        _conv(sd, prefix + ".adaptor", p["adaptor"])
    for key, sub in (("dc1", ".dc.0"), ("dc_dw", ".dc.2"), ("dc2", ".dc.3"),
                     ("ffn1", ".ffn.0"), ("ffn2", ".ffn.2")):
        _conv(sd, prefix + sub, p[key])


def _subpel(sd, prefix, p):
    _conv(sd, prefix + ".conv.0", p["conv"])


def _rbs2(sd, prefix, p):
    _conv(sd, prefix + ".down", p["down"])
    _dcb(sd, prefix + ".conv", p["conv"])


def _rbu(sd, prefix, p):
    _subpel(sd, prefix + ".up", p["up"])
    _dcb(sd, prefix + ".conv", p["conv"])


def dmci(p):
    sd = {}
    _dcb(sd, "enc.enc_1", p["enc1"])
    for i in range(6):
        _dcb(sd, f"enc.enc_2.{i}", p["enc2"][i])
    _conv(sd, "enc.enc_2.6", p["enc_down"])
    _dcb(sd, "hyper_enc.0", p["hyper_enc"][0])
    _rbs2(sd, "hyper_enc.1", p["hyper_enc"][1])
    _rbs2(sd, "hyper_enc.2", p["hyper_enc"][2])
    _rbu(sd, "hyper_dec.0", p["hyper_dec"][0])
    _rbu(sd, "hyper_dec.1", p["hyper_dec"][1])
    _dcb(sd, "hyper_dec.2", p["hyper_dec"][2])
    for i in range(3):
        _dcb(sd, f"y_prior_fusion.{i}", p["y_prior_fusion"][i])
    _conv(sd, "y_prior_fusion.3", p["y_prior_fusion"][3])
    _conv(sd, "y_spatial_prior_reduction", p["reduction"])
    for k in (1, 2, 3):
        _dcb(sd, f"y_spatial_prior_adaptor_{k}", p[f"adaptor_{k}"])
    for i in range(3):
        _dcb(sd, f"y_spatial_prior.{i}", p["y_spatial_prior"][i])
    _conv(sd, "y_spatial_prior.3", p["y_spatial_prior"][3])
    _rbu(sd, "dec.dec_1.0", p["dec1_up"])
    for i in range(1, 13):
        _dcb(sd, f"dec.dec_1.{i}", p["dec1"][i - 1])
    _dcb(sd, "dec.dec_2", p["dec2"])
    _qbank(sd, "q_scale_enc", p["q_scale_enc"])
    _qbank(sd, "q_scale_dec", p["q_scale_dec"])
    _bit_estimator(sd, "bit_estimator_z", p["bit_estimator_z"])
    return sd


def dmc(p):
    sd = {}
    _dcb(sd, "feature_adaptor_i", p["feature_adaptor_i"])
    _conv(sd, "feature_adaptor_p", p["feature_adaptor_p"])
    for i in range(2):
        _dcb(sd, f"feature_extractor.conv1.{i}", p["fe_conv1"][i])
    for i in range(4):
        _dcb(sd, f"feature_extractor.conv2.{i}", p["fe_conv2"][i])
    _conv(sd, "encoder.conv1", p["enc_conv1"])
    for i in range(2):
        _dcb(sd, f"encoder.conv2.{i}", p["enc_conv2"][i])
    _dcb(sd, "encoder.conv3", p["enc_conv3"])
    _conv(sd, "encoder.down", p["enc_down"])
    _dcb(sd, "hyper_encoder.conv.0", p["hyper_enc"][0])
    _rbs2(sd, "hyper_encoder.conv.1", p["hyper_enc"][1])
    _rbs2(sd, "hyper_encoder.conv.2", p["hyper_enc"][2])
    _rbu(sd, "hyper_decoder.conv.0", p["hyper_dec"][0])
    _rbu(sd, "hyper_decoder.conv.1", p["hyper_dec"][1])
    _dcb(sd, "hyper_decoder.conv.2", p["hyper_dec"][2])
    _rbs2(sd, "temporal_prior_encoder", p["temporal_prior"])
    for i in range(3):
        _dcb(sd, f"y_prior_fusion.conv.{i}", p["y_prior_fusion"][i])
    _conv(sd, "y_prior_fusion.conv.3", p["y_prior_fusion"][3])
    for i in range(2):
        _dcb(sd, f"y_spatial_prior.conv.{i}", p["y_spatial_prior"][i])
    _conv(sd, "y_spatial_prior.conv.2", p["y_spatial_prior"][2])
    _subpel(sd, "decoder.up", p["dec_up"])
    for i in range(3):
        _dcb(sd, f"decoder.conv1.{i}", p["dec_conv1"][i])
    _conv(sd, "decoder.conv2", p["dec_conv2"])
    for i in range(4):
        _dcb(sd, f"recon_generation_net.conv.{i}", p["recon_conv"][i])
    _conv(sd, "recon_generation_net.head", p["recon_head"])
    for name in ("q_encoder", "q_decoder", "q_feature", "q_recon"):
        _qbank(sd, name, p[name])
    _bit_estimator(sd, "bit_estimator_z", p["bit_estimator_z"])
    return sd


# --- DCVC-HEM ---------------------------------------------------------------

def _spynet(sd, p, prefix="optic_flow"):
    for j, level in enumerate(p["moduleBasic"]):
        for i in range(1, 6):
            _conv(sd, f"{prefix}.moduleBasic.{j}.conv{i}", level[f"c{i}"])


def _hem_res(sd, prefix, p):
    _conv(sd, prefix + ".conv1", p["c1"])
    _conv(sd, prefix + ".conv2", p["c2"])


def _rbs(sd, prefix, p):
    """HEM's / FM's / EVC's ResidualBlockWithStride."""
    _conv(sd, prefix + ".conv1", p["conv1"])
    _conv(sd, prefix + ".conv2", p["conv2"])
    if "down" in p:
        _conv(sd, prefix + ".downsample", p["down"])


def _rbu3(sd, prefix, p):
    """HEM's / FM's / EVC's ResidualBlockUpsample."""
    _conv(sd, prefix + ".subpel_conv.0", p["subpel"])
    _conv(sd, prefix + ".conv", p["conv"])
    _conv(sd, prefix + ".upsample.0", p["up"])


def _hem_cbr(sd, prefix, p):
    _conv(sd, prefix + ".conv.0", p["c1"])
    _conv(sd, prefix + ".conv.2", p["c2"])
    sd[prefix + ".conv.3.fc.0.weight"] = _a(np.asarray(p["se"]["w1"]).T)
    sd[prefix + ".conv.3.fc.2.weight"] = _a(np.asarray(p["se"]["w2"]).T)
    _conv(sd, prefix + ".up_dim", p["up_dim"])


def _hem_unet(sd, prefix, p):
    for k in ("conv1", "conv2", "conv3"):
        _hem_cbr(sd, f"{prefix}.{k}", p[k])
    for i in range(4):
        _hem_res(sd, f"{prefix}.context_refine.{i}", p["refine"][i])
    _conv(sd, prefix + ".up3.0", p["up3"])
    _hem_cbr(sd, prefix + ".up_conv3", p["up_conv3"])
    _conv(sd, prefix + ".up2.0", p["up2"])
    _hem_cbr(sd, prefix + ".up_conv2", p["up_conv2"])


def _hyper_dec5(sd, prefix, p):
    """HEM's / DC's five-conv hyper decoder."""
    for key, sub in (("c1", ".0"), ("up1", ".2.0"), ("c2", ".4"),
                     ("up2", ".6.0"), ("c3", ".8")):
        _conv(sd, prefix + sub, p[key])


def _stack(sd, prefix, ps):
    _convs(sd, [f"{prefix}.{2 * i}" for i in range(len(ps))], ps)


def _feature_extractor(sd, p, res):
    for i in (1, 2, 3):
        _conv(sd, f"feature_extractor.conv{i}", p[f"c{i}"])
        res(sd, f"feature_extractor.res_block{i}", p[f"r{i}"])


def _ctx_fusion(sd, p, res):
    pre = "context_fusion_net"
    for k in ("3_up", "2_up"):
        _conv(sd, f"{pre}.conv{k}.0", p[f"c{k}"])
    for k in ("3_out", "2_out", "1_out"):
        _conv(sd, f"{pre}.conv{k}", p[f"c{k}"])
    for k in ("3_up", "3_out", "2_up", "2_out", "1_out"):
        res(sd, f"{pre}.res_block{k}", p[f"r{k}"])


def _ctx_enc(sd, p, res):
    pre = "contextual_encoder"
    for i in (1, 2, 3, 4):
        _conv(sd, f"{pre}.conv{i}", p[f"c{i}"])
    res(sd, pre + ".res1", p["r1"])
    res(sd, pre + ".res2", p["r2"])


def _ctx_dec(sd, p, res):
    pre = "contextual_decoder"
    for i in (1, 2, 3, 4):
        _conv(sd, f"{pre}.up{i}.0", p[f"up{i}"])
    res(sd, pre + ".res1", p["r1"])
    res(sd, pre + ".res2", p["r2"])


def dmc_hem(p):
    sd = {}
    _spynet(sd, p["optic_flow"])
    e = p["mv_encoder"]
    for i, k in enumerate(("rbs1", "rb1", "rbs2", "rb2", "rbs3", "rb3")):
        (_rbs if k.startswith("rbs") else _hem_res)(
            sd, f"mv_encoder.{i}", e[k])
    _conv(sd, "mv_encoder.6", e["down"])
    d = p["mv_decoder"]
    for i, k in enumerate(("rb1", "rbu1", "rb2", "rbu2", "rb3", "rbu3",
                           "rb4")):
        (_rbu3 if k.startswith("rbu") else _hem_res)(
            sd, f"mv_decoder.{i}", d[k])
    _conv(sd, "mv_decoder.7.0", d["subpel"])
    _convs(sd, [f"mv_hyper_prior_encoder.{i}" for i in (0, 2, 4, 6, 8)],
           p["mv_hyper_enc"])
    _hyper_dec5(sd, "mv_hyper_prior_decoder", p["mv_hyper_dec"])
    _stack(sd, "mv_y_prior_fusion", p["mv_y_prior_fusion"])
    _stack(sd, "mv_y_spatial_prior", p["mv_y_spatial_prior"])
    _conv(sd, "feature_adaptor_I", p["feature_adaptor_I"])
    _conv(sd, "feature_adaptor_P", p["feature_adaptor_P"])
    _feature_extractor(sd, p["feature_extractor"], _hem_res)
    _ctx_fusion(sd, p["ctx_fusion"], _hem_res)
    _ctx_enc(sd, p["ctx_enc"], _hem_res)
    _convs(sd, [f"contextual_hyper_prior_encoder.{i}" for i in (0, 2, 4)],
           p["hyper_enc"])
    _hyper_dec5(sd, "contextual_hyper_prior_decoder", p["hyper_dec"])
    _conv(sd, "temporal_prior_encoder.0", p["temporal_prior"]["c1"])
    _conv(sd, "temporal_prior_encoder.2", p["temporal_prior"]["c2"])
    _stack(sd, "y_prior_fusion", p["y_prior_fusion"])
    _stack(sd, "y_spatial_prior", p["y_spatial_prior"])
    _ctx_dec(sd, p["ctx_dec"], _hem_res)
    r = p["recon"]
    _conv(sd, "recon_generation_net.first_conv", r["first"])
    _hem_unet(sd, "recon_generation_net.unet_1", r["unet1"])
    _hem_unet(sd, "recon_generation_net.unet_2", r["unet2"])
    _conv(sd, "recon_generation_net.recon_conv", r["head"])
    for name in ("mv_y_q_basic", "mv_y_q_scale", "y_q_basic", "y_q_scale"):
        _vec(sd, name, p[name])
    _bit_estimator(sd, "bit_estimator_z", p["bit_estimator_z"])
    _bit_estimator(sd, "bit_estimator_z_mv", p["bit_estimator_z_mv"])
    return sd


# --- DCVC-TCM ---------------------------------------------------------------

def dmc_tcm(p):
    sd = {}
    _spynet(sd, p["optic_flow"])
    for i in range(3):
        q = p["mv_enc"][i]
        _conv(sd, f"mv_encoder.{4 * i}", q["conv"])
        _gdn(sd, f"mv_encoder.{4 * i + 1}", q["gdn"])
        _hem_res(sd, f"mv_encoder.{4 * i + 2}", q["res"])
    _conv(sd, "mv_encoder.12", p["mv_enc"][3]["conv"])
    _convs(sd, [f"mv_prior_encoder.{i}" for i in (0, 2, 4)],
           p["mv_prior_enc"])
    for i, q in zip((0, 2, 4), p["mv_prior_dec"], strict=True):
        _deconv(sd, f"mv_prior_decoder.{i}", q)
    d = p["mv_dec"]
    for key, i in (("t1", 0), ("t2", 4), ("t3", 6), ("t4", 8)):
        _deconv(sd, f"mv_decoder.{i}", d[key])
    _hem_res(sd, "mv_decoder.2", d["res"])
    for key, i in (("gdn1", 3), ("gdn2", 5), ("gdn3", 7)):
        _gdn(sd, f"mv_decoder.{i}", d[key])
    _conv(sd, "feature_adaptor_I", p["feature_adaptor_I"])
    _conv(sd, "feature_adaptor_P", p["feature_adaptor_P"])
    _feature_extractor(sd, p["feature_extractor"], _hem_res)
    _ctx_fusion(sd, p["ctx_fusion"], _hem_res)
    _ctx_enc(sd, p["ctx_enc"], _hem_res)
    for i in (1, 2, 3):
        _gdn(sd, f"contextual_encoder.gdn{i}", p["ctx_enc"][f"g{i}"])
    _ctx_dec(sd, p["ctx_dec"], _hem_res)
    for i in (1, 2, 3):
        _gdn(sd, f"contextual_decoder.gdn{i}", p["ctx_dec"][f"g{i}"])
    _convs(sd, [f"contextual_hyper_prior_encoder.{i}" for i in (0, 2, 4)],
           p["hyper_enc"])
    for i, q in zip((0, 2, 4), p["hyper_dec"], strict=True):
        _deconv(sd, f"contextual_hyper_prior_decoder.{i}", q)
    t = p["temporal_prior"]
    for i in (1, 2, 3, 4):
        _conv(sd, f"temporal_prior_encoder.conv{i}", t[f"c{i}"])
    for i in (1, 2, 3):
        _gdn(sd, f"temporal_prior_encoder.gdn{i}", t[f"g{i}"])
    _convs(sd, [f"contextual_entropy_parameter.{i}" for i in (0, 2, 4)],
           p["entropy_parameter"])
    r = p["recon"]
    _conv(sd, "recon_generation_net.feature_conv.0", r["first"])
    _hem_res(sd, "recon_generation_net.feature_conv.1", r["res1"])
    _hem_res(sd, "recon_generation_net.feature_conv.2", r["res2"])
    _conv(sd, "recon_generation_net.recon_conv", r["head"])
    _bit_estimator(sd, "bit_estimator_z", p["bit_estimator_z"])
    _bit_estimator(sd, "bit_estimator_z_mv", p["bit_estimator_z_mv"])
    return sd


# --- DCVC-FM and DCVC-DC ----------------------------------------------------

def _fm_dc(sd, prefix, p):
    _conv(sd, prefix + ".conv1.0", p["conv1"])
    _conv(sd, prefix + ".depth_conv", p["dw"])
    _conv(sd, prefix + ".conv2", p["conv2"])
    if "adaptor" in p:
        _conv(sd, prefix + ".adaptor", p["adaptor"])


def _fm_dcb(sd, prefix, p):
    _fm_dc(sd, prefix + ".block.0", p["dc"])
    _conv(sd, prefix + ".block.1.conv.0", p["ffn"]["c1"])
    _conv(sd, prefix + ".block.1.conv.2", p["ffn"]["c2"])


def _fm_dcb4(sd, prefix, p):
    _fm_dc(sd, prefix + ".block.0", p["dc"])
    _conv(sd, prefix + ".block.1.conv", p["ffn"]["c"])
    _conv(sd, prefix + ".block.1.conv_out", p["ffn"]["out"])


def _fm_res(sd, prefix, p):
    _conv(sd, prefix + ".conv1", p["conv1"])
    _conv(sd, prefix + ".conv2", p["conv2"])


def _unet(sd, prefix, p, dcb):
    for k in ("conv1", "conv2", "conv3"):
        dcb(sd, f"{prefix}.{k}", p[k])
    for i in range(4):
        dcb(sd, f"{prefix}.context_refine.{i}", p["refine"][i])
    _conv(sd, prefix + ".up3.0", p["up3"])
    dcb(sd, prefix + ".up_conv3", p["up_conv3"])
    _conv(sd, prefix + ".up2.0", p["up2"])
    dcb(sd, prefix + ".up_conv2", p["up_conv2"])


def _align(sd, p):
    for key, sub in (("off1", "conv_offset.0"), ("off2", "conv_offset.2"),
                     ("off3", "conv_offset.4"), ("fusion", "fusion")):
        _conv(sd, "align." + sub, p[key])


def _mv_enc(sd, p, dcb):
    pre = "mv_encoder"
    _rbs(sd, pre + ".enc_1.0", p["enc1_rbs"])
    dcb(sd, pre + ".enc_1.1", p["enc1_dcb"])
    _rbs(sd, pre + ".enc_2", p["enc2"])
    dcb(sd, pre + ".adaptor_0", p["adaptor_0"])
    dcb(sd, pre + ".adaptor_1", p["adaptor_1"])
    _rbs(sd, pre + ".enc_3.0", p["enc3_rbs"])
    dcb(sd, pre + ".enc_3.1", p["enc3_dcb"])
    _conv(sd, pre + ".enc_3.2", p["enc3_down"])


def _mv_dec(sd, p, dcb):
    pre = "mv_decoder"
    for i in range(5):
        (dcb if i % 2 == 0 else _rbu3)(sd, f"{pre}.dec_1.{i}",
                                       p["dec1"][i])
    _rbu3(sd, pre + ".dec_2", p["dec2"])
    dcb(sd, pre + ".dec_3.0", p["dec3_dcb"])
    _conv(sd, pre + ".dec_3.1.0", p["dec3_subpel"])


def _fusion_and_spatial(sd, p, mv, tag, ref):
    """The y (or mv) prior fusion adaptors and stack and the spatial
    prior's adaptors and stack, FM's and DC's names."""
    _fm_dcb(sd, f"{ref}_prior_fusion_adaptor_0", p[f"{tag}fusion_adaptor_0"])
    _fm_dcb(sd, f"{ref}_prior_fusion_adaptor_1", p[f"{tag}fusion_adaptor_1"])
    for i in range(2):
        _fm_dcb(sd, f"{ref}_prior_fusion.{i}", p[f"{tag}fusion"][i])
    for k in (1, 2, 3):
        _conv(sd, f"{ref}_spatial_prior_adaptor_{k}",
              p[f"{tag}sp_adaptor_{k}"])
    spatial = p["mv_spatial_prior" if mv else "y_spatial_prior"]
    for i in range(3):
        _fm_dcb(sd, f"{ref}_spatial_prior.{i}", spatial[i])


def _fm_dc_common(sd, p, dcb):
    """The towers FM and DC share, with FM's (DepthConvBlock4) or DC's
    (DepthConvBlock) blocks where they differ."""
    _align(sd, p["align"])
    _mv_enc(sd, p["mv_enc"], dcb)
    _mv_dec(sd, p["mv_dec"], dcb)
    _fusion_and_spatial(sd, p, True, "mv_", "mv_y")
    _fusion_and_spatial(sd, p, False, "y_", "y")
    _conv(sd, "feature_adaptor_I", p["feature_adaptor_I"])
    _convs(sd, [f"feature_adaptor.{i}" for i in range(3)],
           p["feature_adaptor"])
    _feature_extractor(sd, p["feature_extractor"], _fm_res)
    _ctx_fusion(sd, p["ctx_fusion"], _fm_res)
    _conv(sd, "temporal_prior_encoder.0", p["temporal_prior"]["c1"])
    _conv(sd, "temporal_prior_encoder.2", p["temporal_prior"]["c2"])
    r = p["recon"]
    _conv(sd, "recon_generation_net.first_conv", r["first"])
    _unet(sd, "recon_generation_net.unet_1", r["unet1"], dcb)
    _unet(sd, "recon_generation_net.unet_2", r["unet2"], dcb)
    _conv(sd, "recon_generation_net.recon_conv", r["head"])
    _bit_estimator(sd, "bit_estimator_z", p["bit_estimator_z"])
    _bit_estimator(sd, "bit_estimator_z_mv", p["bit_estimator_z_mv"])


def _fm_hyper_enc(sd, prefix, p):
    _fm_dcb4(sd, prefix + ".0", p["dcb"])
    _conv(sd, prefix + ".1", p["c1"])
    _conv(sd, prefix + ".3", p["c2"])


def _fm_hyper_dec(sd, prefix, ps):
    _rbu3(sd, prefix + ".0", ps[0])
    _rbu3(sd, prefix + ".1", ps[1])
    _fm_dcb4(sd, prefix + ".2", ps[2])


def dmc_fm(p):
    sd = {}
    for name in ("me_8x", "me_4x", "me_2x", "me_1x"):
        for i in range(1, 6):
            _conv(sd, f"optic_flow.{name}.conv{i}",
                  p["optic_flow"][name][f"c{i}"])
    _fm_dc_common(sd, p, _fm_dcb4)
    _fm_hyper_enc(sd, "mv_hyper_prior_encoder", p["mv_hyper_enc"])
    _fm_hyper_dec(sd, "mv_hyper_prior_decoder", p["mv_hyper_dec"])
    _ctx_enc(sd, p["ctx_enc"], _fm_dcb4)
    _ctx_dec(sd, p["ctx_dec"], _fm_dcb4)
    _fm_hyper_enc(sd, "contextual_hyper_prior_encoder", p["hyper_enc"])
    _fm_hyper_dec(sd, "contextual_hyper_prior_decoder", p["hyper_dec"])
    for name in ("mv_y_q_enc", "mv_y_q_dec", "y_q_enc", "y_q_dec"):
        _q2(sd, name, p[name])
    return sd


def dmc_dc(p):
    sd = {}
    _spynet(sd, p["optic_flow"])
    _fm_dc_common(sd, p, _fm_dcb)
    _convs(sd, [f"mv_hyper_prior_encoder.{i}" for i in (0, 2, 4, 6, 8)],
           p["mv_hyper_enc"])
    _hyper_dec5(sd, "mv_hyper_prior_decoder", p["mv_hyper_dec"])
    _ctx_enc(sd, p["ctx_enc"], _hem_res)
    _ctx_dec(sd, p["ctx_dec"], _hem_res)
    h = p["hyper_enc"]
    _convs(sd, [f"contextual_hyper_prior_encoder.{i}" for i in (0, 2, 4)],
           [h["c0"], h["c1"], h["c2"]])
    _hyper_dec5(sd, "contextual_hyper_prior_decoder", p["hyper_dec"])
    for name in ("mv_y_q_basic_enc", "mv_y_q_basic_dec", "y_q_basic_enc",
                 "y_q_basic_dec", "mv_y_q_scale_enc", "mv_y_q_scale_dec",
                 "y_q_scale_enc", "y_q_scale_dec"):
        _vec(sd, name, p[name])
    return sd


# --- DCVC -------------------------------------------------------------------

def _dcvc_res(sd, prefix, p):
    _conv(sd, prefix + ".conv1", p["c1"])
    _conv(sd, prefix + ".conv2", p["c2"])
    if "adapt" in p:
        _conv(sd, prefix + ".adapt_conv", p["adapt"])


def _dcvc_res01(sd, prefix, p):
    _conv(sd, prefix + ".conv.0", p["c1"])
    _conv(sd, prefix + ".conv.2", p["c2"])


def _gdn_tower(sd, prefix, p, conv=_conv):
    """Convs at even indices, GDNs at odd ones."""
    for i, q in enumerate(p["convs"]):
        conv(sd, f"{prefix}.{2 * i}", q)
    for i, q in enumerate(p["gdns"]):
        _gdn(sd, f"{prefix}.{2 * i + 1}", q)


def dcvc(p):
    sd = {}
    _spynet(sd, p["optic_flow"], "opticFlow")
    _conv(sd, "feature_extract.0", p["feature_extract"]["c"])
    _dcvc_res(sd, "feature_extract.1", p["feature_extract"]["res"])
    _dcvc_res(sd, "context_refine.0", p["context_refine"]["res"])
    _conv(sd, "context_refine.1", p["context_refine"]["c"])
    _gdn_tower(sd, "mvEncoder", p["mv_enc"])
    _gdn_tower(sd, "mvDecoder_part1", p["mv_dec1"], _deconv)
    _stack(sd, "mvDecoder_part2", p["mv_dec2"])
    c = p["ctx_enc"]
    _convs(sd, [f"contextualEncoder.{i}" for i in (0, 3, 6, 8)], c["convs"])
    for i, q in zip((1, 4, 7), c["gdns"], strict=True):
        _gdn(sd, f"contextualEncoder.{i}", q)
    _dcvc_res01(sd, "contextualEncoder.2", c["res"][0])
    _dcvc_res01(sd, "contextualEncoder.5", c["res"][1])
    c = p["ctx_dec1"]
    _convs(sd, [f"contextualDecoder_part1.{i}.0" for i in (0, 2, 5, 8)],
           c["subpels"])
    for i, q in zip((1, 3, 6), c["gdns"], strict=True):
        _gdn(sd, f"contextualDecoder_part1.{i}", q)
    _dcvc_res01(sd, "contextualDecoder_part1.4", c["res"][0])
    _dcvc_res01(sd, "contextualDecoder_part1.7", c["res"][1])
    c = p["ctx_dec2"]
    _conv(sd, "contextualDecoder_part2.0", c["c1"])
    _dcvc_res(sd, "contextualDecoder_part2.1", c["res1"])
    _dcvc_res(sd, "contextualDecoder_part2.2", c["res2"])
    _conv(sd, "contextualDecoder_part2.3", c["c2"])
    for name, key in (("priorEncoder", "prior_enc"),
                      ("mvpriorEncoder", "mv_prior_enc"),
                      ("entropy_parameters", "entropy_parameters"),
                      ("entropy_parameters_mv", "entropy_parameters_mv")):
        _stack(sd, name, p[key])
    for name, key in (("priorDecoder", "prior_dec"),
                      ("mvpriorDecoder", "mv_prior_dec")):
        for i, q in zip((0, 2, 4), p[key], strict=True):
            _deconv(sd, f"{name}.{i}", q)
    _masked_conv(sd, "auto_regressive", p["auto_regressive"])
    _masked_conv(sd, "auto_regressive_mv", p["auto_regressive_mv"])
    _gdn_tower(sd, "temporalPriorEncoder", p["temporal_prior_enc"])
    _bit_estimator(sd, "bitEstimator_z", p["bit_estimator_z"])
    _bit_estimator(sd, "bitEstimator_z_mv", p["bit_estimator_z_mv"])
    return sd


# --- EVC --------------------------------------------------------------------

def _evc_dc(sd, prefix, p, hyper):
    _conv(sd, prefix + ".conv1.0", p["conv1"])
    _conv(sd, prefix + (".depth_conv" if hyper else ".depth_conv.0"),
          p["dw"])
    _conv(sd, prefix + (".conv2" if hyper else ".conv2.0"), p["conv2"])
    if "adaptor" in p:
        _conv(sd, prefix + ".adaptor", p["adaptor"])


def _evc_dcb(sd, prefix, p, hyper=False):
    _evc_dc(sd, prefix + ".block.0", p["dc"], hyper)
    _conv(sd, prefix + ".block.1.conv.0", p["ffn"]["c1"])
    _conv(sd, prefix + ".block.1.conv.2", p["ffn"]["c2"])


def _evc_hp_dcb(sd, prefix, p):
    _evc_dcb(sd, prefix, p, hyper=True)


def evc(p):
    sd = {}
    e = p["enc"]
    for i, k in enumerate(("rbs1", "dcb1", "rbs2", "dcb2", "rbs3", "dcb3")):
        (_rbs if k.startswith("rbs") else _evc_dcb)(sd, f"enc.{i}", e[k])
    _conv(sd, "enc.6", e["down"])
    d = p["dec"]
    for i, k in enumerate(("dcb1", "rbu1", "dcb2", "rbu2", "dcb3", "rbu3",
                           "dcb4")):
        (_rbu3 if k.startswith("rbu") else _evc_dcb)(sd, f"dec.{i}", d[k])
    _conv(sd, "dec.7.0", d["subpel"])
    h = p["hyper"]
    _evc_hp_dcb(sd, "hyper_enc.0", h["he_dcb"])
    _conv(sd, "hyper_enc.1", h["he_c1"])
    _conv(sd, "hyper_enc.3", h["he_c2"])
    for i, key in enumerate(("hd_up1", "hd_up2")):
        _evc_hp_dcb(sd, f"hyper_dec.{i}", h[key]["dcb"])
        _conv(sd, f"hyper_dec.{i}.block.2", h[key]["subpel"])
    _evc_hp_dcb(sd, "hyper_dec.2", h["hd_dcb"])
    _evc_hp_dcb(sd, "y_prior_fusion.0", h["fusion1"])
    _evc_hp_dcb(sd, "y_prior_fusion.1", h["fusion2"])
    for i in range(3):
        _evc_hp_dcb(sd, f"y_spatial_prior.{i}", p["y_spatial_prior"][i])
    _vec(sd, "q_basic", p["q_basic"])
    _vec(sd, "q_scale", p["q_scale"])
    _bit_estimator(sd, "bit_estimator_z", p["bit_estimator_z"])
    return sd


REFERENCE_SD = {"dmci": dmci, "dmc": dmc, "dmc_hem": dmc_hem,
                "dmc_tcm": dmc_tcm, "dmc_fm": dmc_fm, "dcvc": dcvc,
                "dmc_dc": dmc_dc, "evc": evc}
