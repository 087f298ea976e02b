"""The port's RD harness with `--dtype bfloat16`, on the CPU, against itself
and against the JAX harness with `--dtype bfloat16`.

The sequence and config are `test_torch_port_harness.py`'s (4 frames of
64x48 YUV420, qp 21, force_zero_thres 0.12, a refresh at frame 3).  Both
harnesses read the same float32 checkpoints (the port's init at full
width, saved by the JAX package's save_params) into bfloat16 codecs, as a
user passes --model_path_i/_p.  Held:
  * the port's decoder is exact: each decoded I-frame equals the
    encoder's x_hat and each decoded P-frame's feature the encoder's;
  * the JSON's bits are 8 x the .bin's size; its keys are the JAX
    harness's;
  * per-frame PSNR within PSNR_DB of the JAX harness's.  In bfloat16 the
    two packages' symbols differ (test_torch_port_bf16.py), so no
    rounding bound applies: PSNR_DB is the bound the card's smoke run
    holds a recon file's PSNR to; the first run measured 0.026 dB;
  * `get_distortion` on a bfloat16 x_hat equals the JAX harness's, PNG
    and YUV420: the crop, colour conversion (its constants rounded to
    bfloat16 as JAX rounds them), * 255 and clip run in bfloat16 on both
    sides before the metrics read float32.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.eval import harness as JH
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.eval import harness as PH
from opendcvc_tpu_torch.models import dmc as PDMC
from opendcvc_tpu_torch.models import dmci as PDMCI
from test_torch_port_bf16 import _nchw, _to_jax
from test_torch_port_harness import (H, N, QP, W, _argv, _dataset,
                                     _jax_main, _port_main)
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

BF = torch.bfloat16
PSNR_DB = 0.5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The port's float32 inits (seeds 0 and 1), saved as JAX package
    checkpoints."""
    d = tmp_path_factory.mktemp("weights_bf16")
    paths = {"i": str(d / "dmci.msgpack"), "p": str(d / "dmc.msgpack")}
    JCK.save_params(paths["i"], _to_jax(
        PDMCI.DMCI(device="cpu").init_params(seed=0)))
    JCK.save_params(paths["p"], _to_jax(
        PDMC.DMC(device="cpu").init_params(seed=1)))
    return paths


def _recording(log):
    """PH.build_nets, with each codec's compress / decompress recording
    the encoder's x_hat (I) or feature (P) and the decoder's."""
    build = PH.build_nets

    def nets(args):
        i_net, p_net = build(args)
        log["dtypes"] = (i_net.dtype, p_net.dtype,
                         p_net.params["q_encoder"].dtype)
        for kind, net in (("I", i_net), ("P", p_net)):
            enc, dec = net.compress, net.decompress

            def compress(x, qp, _net=net, _enc=enc, _kind=kind):
                out = _enc(x, qp)
                log["enc"].append(out["x_hat"] if _kind == "I"
                                  else _net.dpb[0].feature)
                return out

            def decompress(s, sps, qp, _net=net, _dec=dec, _kind=kind):
                out = _dec(s, sps, qp)
                log["dec"].append(out["x_hat"] if _kind == "I"
                                  else _net.dpb[0].feature)
                return out

            net.compress, net.decompress = compress, decompress
        return i_net, p_net
    return nets


@pytest.fixture(scope="module")
def run(weights, tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16_yuv420")
    cfg = _dataset(root, "yuv420")
    ckpts = ["--model_path_i", weights["i"], "--model_path_p", weights["p"],
             "--dtype", "bfloat16"]
    _jax_main(_argv(cfg, root, "jax", *ckpts))
    log = {"enc": [], "dec": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PH, "build_nets", _recording(log))
        _port_main(_argv(cfg, root, "port", "--device", "cpu", *ckpts))
    out = {"log": log}
    for tag in ("jax", "port"):
        bins = root / f"{tag}_bins" / "tiny"
        out[tag] = {"bin": (bins / f"seq_q{QP}.bin").read_bytes(),
                    "log": json.loads((bins / f"seq_q{QP}.json").read_text()),
                    "out": json.loads((root / f"{tag}.json").read_text())}
    return out


def test_codecs_are_bf16_with_checkpoint_weights_as_loaded(run):
    """bfloat16 codecs; the float32 checkpoint is kept as loaded."""
    assert run["log"]["dtypes"] == (BF, BF, torch.float32)


def test_decoder_exact(run):
    enc, dec = run["log"]["enc"], run["log"]["dec"]
    assert len(enc) == len(dec) == N
    for t, (e, d) in enumerate(zip(enc, dec)):
        assert e.dtype == BF and torch.equal(e, d), t


def test_bits_are_the_bin(run):
    p = run["port"]
    bits = sum(p["log"]["frame_bpp"]) * p["log"]["frame_pixel_num"]
    assert round(bits) == 8 * len(p["bin"])
    assert p["log"]["frame_type"] == run["jax"]["log"]["frame_type"]


def test_json_keys_match_jax(run):
    j, p = run["jax"], run["port"]
    assert list(p["log"]) == list(j["log"])
    jo, po = j["out"]["tiny"]["seq"]["000"], p["out"]["tiny"]["seq"]["000"]
    assert list(po) == list(jo)


def test_psnr_within_bound_of_jax(run):
    j, p = run["jax"]["log"], run["port"]["log"]
    diffs = np.abs(np.asarray(p["frame_psnr"]) - np.asarray(j["frame_psnr"]))
    print(f"bf16 harness PSNR, port - JAX: max {diffs.max():.4f} dB")
    assert np.isfinite(p["frame_psnr"]).all()
    assert diffs.max() <= PSNR_DB


@pytest.mark.parametrize("src_type", ["png", "yuv420"])
def test_get_distortion_bf16_matches_jax(src_type, tmp_path):
    """A bfloat16 x_hat (a noisy copy of the padded input) through both
    harnesses' post-processing and metrics: equal PSNR."""
    _dataset(tmp_path, src_type, n=1)
    args = {"src_type": src_type, "src_width": W, "src_height": H,
            "frame_num": 1, "device": "cpu", "calc_ssim": False,
            "src_path": str(tmp_path / "data" / "seq")}
    jx, *orig = JH.get_src_frame(args, JH.get_src_reader(args), (8, 16))
    noise = np.random.default_rng(9).normal(0, 0.05, jx.shape)
    x_hat = jnp.asarray(np.clip(np.asarray(jx) + noise, 0, 1),
                        jnp.bfloat16)
    want = JH.get_distortion(args, x_hat, *orig)
    got = PH.get_distortion(args, _nchw(x_hat).permute(0, 2, 3, 1), *orig)
    assert got == want
