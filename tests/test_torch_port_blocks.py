"""Port fused ops and NN blocks against the JAX package (CPU, float32).

Inputs come from numpy (default_rng), weights from the JAX package's own
init functions carried across with `utils/params.py`.  Integer outputs
must be equal.  Float outputs must agree within atol = 1e-5 * max|ref|:
the conv accumulation order differs between XLA:CPU and ATen.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.layers import blocks as JB
from opendcvc_tpu.models import common as JC
from opendcvc_tpu.ops import fused as JF
from opendcvc_tpu_torch.layers import blocks as PB
from opendcvc_tpu_torch.models import common as PC
from opendcvc_tpu_torch.ops import fused as PF
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2),
                                      order="C"))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=1e-5 * max(float(np.abs(ref).max()),
                                               1e-30))


def _rand(seed, shape, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# fused ops: (name, fn(seed) -> list of (port output, JAX output, exact))
# ---------------------------------------------------------------------------

def _case_pixel_shuffle(seed):
    x = _rand(seed, (1, 16, 24, 3))
    d = _rand(seed + 1, (1, 2, 3, 192))
    return [(_nhwc(PF.space_to_depth(_nchw(x), 8)), JF.space_to_depth(x, 8),
             True),
            (_nhwc(PF.depth_to_space(_nchw(d), 8)), JF.depth_to_space(d, 8),
             True),
            (_nhwc(PF.pixel_shuffle_clamp(_nchw(d), 8)),
             JF.pixel_shuffle_clamp(d, 8), True)]


def _case_round_int8(seed):
    z = _rand(seed, (1, 3, 5, 8), -200.0, 200.0)
    z[0, 0, 0, :4] = [0.5, 1.5, -2.5, 2.5]            # half-to-even ties
    zh, zi = PF.round_and_to_int8(_nchw(z))
    jh, ji = JF.round_and_to_int8(jnp.asarray(z))
    return [(_nhwc(zh), jh, True), (_nhwc(zi), ji, True)]


def _masks(seed):
    out = []
    for c in (8, 16):
        for p, j in zip(PF.checkerboard_masks_2x(5, 6, c, torch.float32),
                        JF.checkerboard_masks_2x(5, 6, c, jnp.float32)):
            out.append((_nhwc(p), j, True))
        for p, j in zip(PF.checkerboard_masks_4x(5, 6, c, torch.float32),
                        JF.checkerboard_masks_4x(5, 6, c, jnp.float32)):
            out.append((_nhwc(p), j, True))
    return out


def _case_process_with_mask(seed):
    out = []
    y, s, m = (_rand(seed + i, (1, 4, 6, 16), -6.0, 6.0) for i in range(3))
    s = np.abs(s) * 0.1
    pm = PF.checkerboard_masks_2x(4, 6, 16, torch.float32)[1]
    jm = JF.checkerboard_masks_2x(4, 6, 16, jnp.float32)[1]
    for fz in (None, 0.12):
        got = PF.process_with_mask(_nchw(y), _nchw(s), _nchw(m), pm, fz)
        ref = JF.process_with_mask(y, s, m, jm, fz)
        out += [(_nhwc(g), r, i == 1) for i, (g, r) in
                enumerate(zip(got, ref))]
    return out


def _case_fold_restore(seed):
    x, means = _rand(seed, (1, 4, 6, 16)), _rand(seed + 1, (1, 4, 6, 16))
    yh, yq = _rand(seed + 2, (1, 4, 6, 8)), _rand(seed + 3, (1, 4, 6, 4))
    pm2 = PF.checkerboard_masks_2x(4, 6, 16, torch.float32)[0]
    jm2 = JF.checkerboard_masks_2x(4, 6, 16, jnp.float32)[0]
    pm4 = PF.checkerboard_masks_4x(4, 6, 16, torch.float32)[2]
    jm4 = JF.checkerboard_masks_4x(4, 6, 16, jnp.float32)[2]
    return [
        (_nhwc(PF.fold_halves(_nchw(x))), JF.fold_halves(x), False),
        (_nhwc(PF.fold_quarters(_nchw(x))), JF.fold_quarters(x), False),
        (_nhwc(PF.combine_for_reading_2x(_nchw(x), pm2)),
         JF.combine_for_reading_2x(x, jm2), False),
        (_nhwc(PF.restore_y_2x(_nchw(yh), _nchw(means), pm2)),
         JF.restore_y_2x(yh, means, jm2), False),
        (_nhwc(PF.restore_y_4x(_nchw(yq), _nchw(means), pm4)),
         JF.restore_y_4x(yq, means, jm4), False)]


_IDX = (0.11, 16.0, float(np.log(0.11)), 127 / (np.log(16.0) - np.log(0.11)))


def _case_build_index(seed):
    out = []
    scales = np.exp(_rand(seed, (1, 4, 6, 8), -3.0, 3.5))
    sym = np.round(_rand(seed + 1, (1, 4, 6, 8), -120.0, 120.0))
    for fz in (None, 0.12):
        gi, gk = PF.build_index_dec(_nchw(scales), *_IDX[:3],
                                    float(_IDX[3]), fz)
        ri, rk = JF.build_index_dec(scales, *_IDX, fz)
        out.append((_nhwc(gi), ri, True))
        if fz is not None:
            out.append((_nhwc(gk), rk, True))
        gp, _ = PF.build_index_enc(_nchw(sym), _nchw(scales), *_IDX[:3],
                                   float(_IDX[3]), fz)
        rp, _ = JF.build_index_enc(sym, scales, *_IDX, fz)
        out.append((_nhwc(gp), rp, True))
    return out


def _case_pads_and_priors(seed):
    y = _rand(seed, (1, 5, 7, 6))
    img = _rand(seed + 1, (1, 4, 6, 10))
    vid = _rand(seed + 2, (1, 4, 6, 9))
    lat = _rand(seed + 3, (1, 4, 6, 3))
    out = [(_nhwc(PF.replicate_pad(_nchw(y), 3, 1)),
            JF.replicate_pad(y, 3, 1), True),
           (_nhwc(PC.pad_for_y(_nchw(y))), JC.pad_for_y(y), True)]
    pairs = list(zip(PC.separate_prior_image(_nchw(img)),
                     JC.separate_prior_image(img)))
    pairs += zip(PC.separate_prior_video_encoding(_nchw(vid), _nchw(lat)),
                 JC.separate_prior_video_encoding(vid, lat))
    pairs += zip(PC.separate_prior_video_decoding(_nchw(vid)),
                 JC.separate_prior_video_decoding(vid))
    return out + [(_nhwc(g), r, False) for g, r in pairs]


FUSED = {
    "pixel_shuffle": _case_pixel_shuffle,
    "round_and_to_int8": _case_round_int8,
    "checkerboard_masks": _masks,
    "process_with_mask": _case_process_with_mask,
    "fold_restore": _case_fold_restore,
    "build_index": _case_build_index,
    "pads_and_priors": _case_pads_and_priors,
}


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_op_matches_jax(name):
    for got, ref, exact in FUSED[name](7):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        if exact:
            np.testing.assert_array_equal(got, ref)
        else:
            _close(got, ref)


def test_codec_geometry_helpers_match_jax():
    for h, w in ((64, 64), (1088, 1920), (48, 80), (1080, 1920)):
        for p in (4, 16, 64):
            assert PC.get_padding_size(h, w, p) == JC.get_padding_size(h, w,
                                                                       p)
            assert PC.get_downsampled_shape(h, w, p) == \
                JC.get_downsampled_shape(h, w, p)


# ---------------------------------------------------------------------------
# blocks: (init in JAX, apply in both)
# ---------------------------------------------------------------------------

def _blocks():
    k = jax.random.PRNGKey
    return {
        "conv1x1": (JB.conv_init(k(1), 12, 20, 1),
                    lambda m, p, x: m.conv_apply(p, x), 12),
        "conv3x3_s2": (JB.conv_init(k(2), 12, 8, 3),
                       lambda m, p, x: m.conv_apply(p, x, stride=2,
                                                    padding=1), 12),
        "conv_depthwise": (JB.conv_init(k(3), 12, 12, 3, groups=12),
                           lambda m, p, x: m.conv_apply(p, x, padding=1,
                                                        groups=12), 12),
        "wsilu": ({}, lambda m, p, x: m.wsilu(x), 12),
        "wsilu_chunk_add": ({}, lambda m, p, x: m.wsilu_chunk_add(x), 12),
        "subpel_conv2x": (JB.subpel_conv2x_init(k(4), 12, 6, 3),
                          lambda m, p, x: m.subpel_conv2x_apply(p, x,
                                                                padding=1),
                          12),
        "depth_conv_block": (JB.depth_conv_block_init(k(5), 12, 12),
                             lambda m, p, x: m.depth_conv_block_apply(p, x),
                             12),
        "depth_conv_block_adaptor_quant": (
            JB.depth_conv_block_init(k(6), 12, 16, force_adaptor=True),
            lambda m, p, x: m.depth_conv_block_apply(
                p, x, quant_step=0.75, shortcut=True), 12),
        "res_block_stride2": (JB.res_block_stride2_init(k(7), 12, 16),
                              lambda m, p, x: m.res_block_stride2_apply(p,
                                                                        x),
                              12),
        "res_block_upsample": (JB.res_block_upsample_init(k(8), 12, 8),
                               lambda m, p, x: m.res_block_upsample_apply(
                                   p, x), 12),
    }


@pytest.mark.parametrize("name", sorted(_blocks()))
def test_block_matches_jax(name):
    params, apply, c = _blocks()[name]
    x = _rand(11, (1, 8, 12, c))
    ref = apply(JB, params, jnp.asarray(x))
    got = apply(PB, from_jax(params), _nchw(x))
    got = _nhwc(got)
    assert got.shape == np.asarray(ref).shape
    _close(got, ref)


def test_weight_bridge_transposes_conv_weights_only():
    p = {"conv": JB.conv_init(jax.random.PRNGKey(0), 4, 6, 3),
         "dw": JB.conv_init(jax.random.PRNGKey(1), 5, 5, 3, groups=5),
         "bank": np.arange(12.0, dtype=np.float32).reshape(3, 4),
         "list": [{"w": np.ones((2, 3), np.float32)}]}
    t = from_jax(p)
    np.testing.assert_array_equal(t["conv"]["w"].numpy(),
                                  np.asarray(p["conv"]["w"])
                                  .transpose(3, 2, 0, 1))
    assert tuple(t["dw"]["w"].shape) == (5, 1, 3, 3)
    np.testing.assert_array_equal(t["conv"]["b"].numpy(), p["conv"]["b"])
    np.testing.assert_array_equal(t["bank"].numpy(), p["bank"])
    assert tuple(t["list"][0]["w"].shape) == (2, 3)
