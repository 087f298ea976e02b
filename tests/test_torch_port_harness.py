"""The port's RD harness (`opendcvc_tpu_torch.eval.harness`) against the
JAX package's (`opendcvc_tpu.eval.harness`), on the CPU.

One generated sequence per source type, 4 frames at 64x48 (a smooth
gradient, a texture shifted 2 px a frame, mild noise; numpy seeds), in
PNG and in raw YUV420.  Both harnesses code it with the same weights: the
JAX package's `init_params(0)` / `init_params(1)`, saved by its
`save_params` and read by the port's JAX-free checkpoint reader.  The JAX
codecs run their host-EC path (OPENDCVC_TPU_DEVICE_EC unset) with their
plain coder (OPENDCVC_TPU_FORCE_PY_RANS=1).  --reset_interval 2 puts a
host-EC periodic refresh at frame 3, mid-chain.  Held:
  * the prepared codec inputs: YUV420 exactly (numpy upsampling and
    replicate padding on both sides), PNG within PNG_INPUT_ATOL;
  * the .bin files are byte-identical;
  * the JSON logs have the same keys, bits, frame counts and types;
  * PSNR agrees within the bound `_psnr_tol` derives from the codecs'
    float agreement (and `get_distortion` alone, on one frame, within
    the bound from the colour transforms' agreement);
  * the recon files agree within one code value.
Also: --worker 2 equals serial, --check_existing returns the stored log,
the unported mode (estimate) raises, --dtype bfloat16 codes, and the
default --device cuda raises without CUDA.
"""

import io
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from opendcvc_tpu.eval import harness as JH
from opendcvc_tpu.models import dmc as JDMC
from opendcvc_tpu.models import dmci as JDMCI
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.eval import harness as PH
from opendcvc_tpu_torch.utils import stream_helper as S
from opendcvc_tpu_torch.utils.common import dump_json
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

H, W, N = 48, 64, 4
QP = 21
SRC_TYPES = ["png", "yuv420"]
# rgb2ycbcr runs in float32 on XLA and on torch; their roundings of the
# same ops may differ by a few ulps of values in [0, 1]
PNG_INPUT_ATOL = 1e-6
# the codecs' floats agree within 1e-4 * max|ref| (test_torch_port_codec
# and _host_ec), and x_hat lies in [0, 1]
X_HAT_ATOL = 1e-4
# ycbcr2rgb's largest row sum of |coefficients| (1 + 2 - 2 * Kb)
RGB_GAIN = 1 + 2 - 2 * 0.0722
# the torch and jnp colour transforms on one input: a few ulps of values
# in [0, 1], in code values
TRANSFORM_EPS = 1e-6 * 255


def _frames(src_type, h=H, w=W, n=N):
    """n frames: (H, W, 3) uint8 RGB, or (y (H, W), uv (2, H/2, W/2))."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w + 2 * n]
    smooth = np.stack([(3 * xx + 2 * yy) % 256, 96 + xx, 200 - 2 * yy], -1)
    tex = rng.integers(0, 48, (h, w + 2 * n, 3))
    out = []
    for t in range(n):
        img = smooth[:, 2 * t:2 * t + w] + tex[:, 2 * t:2 * t + w] \
            + rng.normal(0, 2.0, (h, w, 3))
        img = np.clip(img, 0, 255).astype(np.uint8)
        if src_type == "png":
            out.append(img)
        else:
            out.append((img[:, :, 0], img[::2, ::2, 1:].transpose(2, 0, 1)))
    return out


def _dataset(root, src_type, h=H, w=W, n=N):
    """Write the sequence and its dataset config; returns the config."""
    data = root / "data"
    data.mkdir(parents=True, exist_ok=True)
    if src_type == "png":
        (data / "seq").mkdir(exist_ok=True)
        for t, img in enumerate(_frames(src_type, h, w, n)):
            Image.fromarray(img).save(data / "seq" / f"im{t + 1}.png")
    else:
        with open(data / "seq.yuv", "wb") as f:
            for y, uv in _frames(src_type, h, w, n):
                f.write(y.tobytes())
                f.write(np.ascontiguousarray(uv).tobytes())
    cfg = root / "config.json"
    cfg.write_text(json.dumps({"root_path": str(root), "test_classes": {
        "tiny": {"test": 1, "base_path": "data", "src_type": src_type,
                 "sequences": {"seq": {"width": w, "height": h,
                                       "frames": n, "intra_period": -1}}}}}))
    return str(cfg)


def _argv(cfg, root, tag, *extra):
    return ["--test_config", cfg, "--output_path", str(root / f"{tag}.json"),
            "--stream_path", str(root / f"{tag}_bins"), "--rate_num", "1",
            "--qp_i", str(QP), "--qp_p", str(QP), "--reset_interval", "2",
            "--force_zero_thres", "0.12", "--verbose_json", "1",
            "--save_decoded_frame", "1", "--seed", "0", *extra]


def _jax_main(argv):
    """The JAX harness on its host-EC path with its plain coder."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        JH.main(argv)


def _port_main(argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
        PH.main(argv)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX package's init_params(0) / (1), saved by its save_params."""
    d = tmp_path_factory.mktemp("weights")
    paths = {"i": str(d / "dmci.msgpack"), "p": str(d / "dmc.msgpack")}
    JCK.save_params(paths["i"], JDMCI.DMCI().init_params(seed=0))
    JCK.save_params(paths["p"], JDMC.DMC().init_params(seed=1))
    return paths


def _outputs(root, tag, src_type):
    bins = root / f"{tag}_bins" / "tiny"
    if src_type == "png":
        recon = [np.asarray(Image.open(bins / f"im{t + 1:05d}.png"))
                 for t in range(N)]
    else:
        (rec,) = [p for p in os.listdir(bins) if p.endswith("kbps.yuv")]
        recon = np.fromfile(bins / rec, np.uint8)
    return {"bin": (bins / f"seq_q{QP}.bin").read_bytes(),
            "log": json.loads((bins / f"seq_q{QP}.json").read_text()),
            "out": json.loads((root / f"{tag}.json").read_text()),
            "recon": recon}


@pytest.fixture(scope="module", params=SRC_TYPES)
def run(request, weights, tmp_path_factory):
    """One JAX and one port harness run on one source type."""
    src_type = request.param
    root = tmp_path_factory.mktemp(src_type)
    cfg = _dataset(root, src_type)
    _jax_main(_argv(cfg, root, "jax"))
    _port_main(_argv(cfg, root, "port", "--device", "cpu",
                     "--model_path_i", weights["i"],
                     "--model_path_p", weights["p"]))
    return {"src_type": src_type, "root": root,
            "jax": _outputs(root, "jax", src_type),
            "port": _outputs(root, "port", src_type)}


def test_prepared_inputs_match(run):
    """Before any coding: the codec input of every frame, padded (here by
    8 rows and 16 columns, so the padding is exercised too)."""
    src_type = run["src_type"]
    args = {"src_type": src_type, "src_width": W, "src_height": H,
            "frame_num": N, "device": "cpu",
            "src_path": str(run["root"] / "data" / "seq")}
    readers = (JH.get_src_reader(args), PH.get_src_reader(args))
    for t in range(N):
        jx, jy, ju, jv, jrgb = JH.get_src_frame(args, readers[0], (8, 16))
        px, py, pu, pv, prgb = PH.get_src_frame(args, readers[1], (8, 16))
        jx, px = np.asarray(jx), px.numpy()
        assert px.shape == jx.shape == (1, H + 8, W + 16, 3)
        if src_type == "yuv420":
            np.testing.assert_array_equal(px, jx, err_msg=f"frame {t}")
            for a, b in ((py, jy), (pu, ju), (pv, jv)):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(px, jx, rtol=0, atol=PNG_INPUT_ATOL,
                                       err_msg=f"frame {t}")
            np.testing.assert_array_equal(prgb, jrgb)
    for r in readers:
        r.close()


def test_get_distortion_matches(run):
    """The metrics path alone: the same perturbed frame as x_hat through
    both harnesses' crop, colour conversion, clip and metrics."""
    src_type = run["src_type"]
    args = {"src_type": src_type, "src_width": W, "src_height": H,
            "frame_num": N, "device": "cpu", "calc_ssim": False,
            "src_path": str(run["root"] / "data" / "seq")}
    jx, *orig = JH.get_src_frame(args, JH.get_src_reader(args), (8, 16))
    noise = np.random.default_rng(9).normal(0, 0.05, jx.shape)
    x_hat = np.clip(np.asarray(jx) + noise, 0, 1).astype(np.float32)
    want = JH.get_distortion(args, jnp.asarray(x_hat), *orig)
    got = PH.get_distortion(args, torch.from_numpy(x_hat), *orig)
    eps = TRANSFORM_EPS * (RGB_GAIN if src_type == "png" else 1)
    for g, w in zip(got[0], want[0]):
        assert 10 < w < 99 and abs(g - w) <= _psnr_tol(w, eps)


def test_bin_byte_identical(run):
    assert run["port"]["bin"] == run["jax"]["bin"]


def test_stream_refreshes_mid_chain(run):
    """The SPS of frame 3 carries use_ada_i: the encoder re-anchored its
    feature from pixels there, and the decoder followed."""
    rd, helper, ada = io.BytesIO(run["port"]["bin"]), S.SPSHelper(), []
    for _ in range(N):
        header = S.read_header(rd)
        while header["nal_type"] == S.NalType.NAL_SPS:
            helper.add_sps_by_id(S.read_sps_remaining(rd, header["sps_id"]))
            header = S.read_header(rd)
        ada.append(helper.get_sps_by_id(header["sps_id"])["use_ada_i"])
        S.read_ip_remaining(rd)
    assert ada == [0, 1, 0, 1]


def test_json_layout_bits_and_frames(run):
    j, p = run["jax"], run["port"]
    assert list(p["log"]) == list(j["log"])
    for key in ("frame_pixel_num", "i_frame_num", "p_frame_num",
                "frame_type", "frame_bpp", "ave_i_frame_bpp",
                "ave_p_frame_bpp", "ave_all_frame_bpp"):
        assert p["log"][key] == j["log"][key], key
    bits = sum(p["log"]["frame_bpp"]) * p["log"]["frame_pixel_num"]
    assert round(bits) == 8 * (len(p["bin"]))
    jo, po = j["out"]["tiny"]["seq"]["000"], p["out"]["tiny"]["seq"]["000"]
    assert list(po) == list(jo)
    assert po["frame_bpp"] == jo["frame_bpp"]


def _psnr_tol(psnr, eps):
    """Largest PSNR change when every sample moves by at most eps (code
    values): with rmse from the PSNR, the MSE moves by at most
    2 eps rmse + eps^2."""
    rmse = 255.0 * 10 ** (-psnr / 20)
    delta = (2 * eps * rmse + eps * eps) / (rmse * rmse)
    return -10 * math.log10(1 - delta)


def test_psnr_within_tolerance(run):
    j, p = run["jax"]["log"], run["port"]["log"]
    eps = X_HAT_ATOL * 255 * (RGB_GAIN if run["src_type"] == "png" else 1)
    keys = ["frame_psnr"] + [k for k in j if "psnr" in k and k[0] == "a"]
    for key in keys:
        want, got = np.atleast_1d(j[key]), np.atleast_1d(p[key])
        for a, b in zip(got, want):
            assert np.isfinite(a) and abs(a - b) <= _psnr_tol(b, eps), key


def test_recon_within_one_code_value(run):
    j, p = run["jax"]["recon"], run["port"]["recon"]
    if run["src_type"] == "yuv420":
        assert p.size == j.size == N * H * W * 3 // 2
    for a, b in zip(np.atleast_2d(p), np.atleast_2d(j)):
        diff = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
        assert diff.max() <= 1


# ---------------------------------------------------------------------------
# the port harness alone
# ---------------------------------------------------------------------------

def _strip_times(d):
    if isinstance(d, dict):
        return {k: _strip_times(v) for k, v in d.items() if "time" not in k}
    return d


def test_worker_fanout_identical(tmp_path):
    """--worker 2 (a codec pair per thread) gives serial's results."""
    cfg = _dataset(tmp_path, "png", n=2)
    outs = {}
    for tag in ("w1", "w2"):
        _port_main(["--test_config", cfg,
                    "--output_path", str(tmp_path / f"{tag}.json"),
                    "--stream_path", str(tmp_path / f"bins_{tag}"),
                    "--rate_num", "2", "--qp_i", "10", "50",
                    "--qp_p", "10", "50", "--device", "cpu",
                    "--worker", tag[1]])
        outs[tag] = json.loads((tmp_path / f"{tag}.json").read_text())
    assert _strip_times(outs["w1"]) == _strip_times(outs["w2"])
    for rate in ("000", "001"):
        assert outs["w2"]["tiny"]["seq"][rate]["p_frame_num"] == 1


def test_check_existing_returns_the_stored_log(tmp_path):
    cfg = _dataset(tmp_path, "yuv420", n=2)
    argv = ["--test_config", cfg, "--output_path", str(tmp_path / "o.json"),
            "--stream_path", str(tmp_path / "bins"), "--rate_num", "1",
            "--qp_i", "30", "--qp_p", "30", "--device", "cpu"]
    _port_main(argv)
    log_path = tmp_path / "bins" / "tiny" / "seq_q30.json"
    log = json.loads(log_path.read_text())
    log["test_time"] = -1.0          # a value no run would write
    log_path.write_text(json.dumps(log))
    _port_main(argv + ["--check_existing", "1"])
    got = json.loads((tmp_path / "o.json").read_text())["tiny"]["seq"]["000"]
    stored = io.StringIO()
    dump_json(log, stored, float_digits=6)     # as main writes its output
    assert got["test_time"] == -1.0
    assert {k: got[k] for k in log} == json.loads(stored.getvalue())


@pytest.mark.parametrize("flag", [("--write_stream", "0")],
                         ids=["estimate_mode"])
def test_unported_modes_raise(tmp_path, flag):
    cfg = _dataset(tmp_path, "yuv420", n=1)
    with pytest.raises(NotImplementedError, match="not ported"):
        _port_main(["--test_config", cfg, "--device", "cpu",
                    "--output_path", str(tmp_path / "o.json"),
                    "--stream_path", str(tmp_path / "bins"), *flag])
    assert not (tmp_path / "bins").exists()


def test_bfloat16_mode_codes(tmp_path):
    """--dtype bfloat16 codes and decodes (the port's --seed weights cast
    to bfloat16): one rate of 2 frames, a .bin and a finite PSNR.  The
    bfloat16 harness against the JAX harness's is
    test_torch_port_bf16_harness.py."""
    cfg = _dataset(tmp_path, "yuv420", n=2)
    _port_main(["--test_config", cfg, "--device", "cpu", "--dtype",
                "bfloat16", "--output_path", str(tmp_path / "o.json"),
                "--stream_path", str(tmp_path / "bins"), "--rate_num", "1",
                "--qp_i", str(QP), "--qp_p", str(QP), "--verbose_json", "1"])
    log = json.loads((tmp_path / "bins" / "tiny" /
                      f"seq_q{QP}.json").read_text())
    assert (log["i_frame_num"], log["p_frame_num"]) == (1, 1)
    assert np.isfinite(log["frame_psnr"]).all()
    bits = sum(log["frame_bpp"]) * log["frame_pixel_num"]
    assert round(bits) == 8 * (tmp_path / "bins" / "tiny" /
                               f"seq_q{QP}.bin").stat().st_size


def test_default_device_cuda_raises_without_cuda(tmp_path):
    """--device defaults to cuda; without CUDA the harness raises before
    it reads a frame, and never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert PH.parse_args(["--test_config", "c", "--output_path", "o"]) \
        .device == "cuda"
    cfg = _dataset(tmp_path, "yuv420", n=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _port_main(["--test_config", cfg,
                    "--output_path", str(tmp_path / "o.json"),
                    "--stream_path", str(tmp_path / "bins")])
    assert not (tmp_path / "bins").exists()
    assert not (tmp_path / "o.json").exists()
