"""The port's RD harness against the JAX package's with --calc_ssim 1.

MS-SSIM needs frames of at least 88x88, so this case has its own PNG
sequence: 2 frames at 96x88 (the codecs see 96x96: 8 replicate-padded rows
that the metrics crop away).  Same weights and coder settings as
test_torch_port_harness.py.  Held: byte-identical .bin files, equal bits,
PSNR within the bound derived there, and MS-SSIM within MSSSIM_ATOL.
"""

import json

import numpy as np
import pytest
from PIL import Image

from opendcvc_tpu.eval import harness as JH
from opendcvc_tpu.models import dmc as JDMC
from opendcvc_tpu.models import dmci as JDMCI
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.eval import harness as PH
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

H, W, N = 88, 96, 2
QP = 30
# x_hat agrees within 1e-4 (the codecs' float agreement), so each RGB
# sample within ~7e-2 code values after ycbcr2rgb; SSIM's constants
# (C1 = 6.5, C2 = 58.5) bound how far such a move shifts each term, and
# MS-SSIM is a product of five such terms in [0, 1]
MSSSIM_ATOL = 1e-4


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ssim")
    (root / "data" / "seq").mkdir(parents=True)
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:H, 0:W + 2 * N]
    base = np.stack([2 * xx + yy, 120 + xx, 220 - yy], -1) \
        + rng.integers(0, 40, (H, W + 2 * N, 3))
    for t in range(N):
        img = base[:, 2 * t:2 * t + W] + rng.normal(0, 2.0, (H, W, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            root / "data" / "seq" / f"im{t + 1}.png")
    cfg = root / "config.json"
    cfg.write_text(json.dumps({"root_path": str(root), "test_classes": {
        "ssim": {"test": 1, "base_path": "data", "src_type": "png",
                 "sequences": {"seq": {"width": W, "height": H, "frames": N,
                                       "intra_period": -1}}}}}))
    weights = {"i": str(root / "dmci.msgpack"), "p": str(root / "dmc.msgpack")}
    JCK.save_params(weights["i"], JDMCI.DMCI().init_params(seed=0))
    JCK.save_params(weights["p"], JDMC.DMC().init_params(seed=1))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        for tag, main, extra in (
                ("jax", JH.main, []),
                ("port", PH.main, ["--device", "cpu",
                                   "--model_path_i", weights["i"],
                                   "--model_path_p", weights["p"]])):
            main(["--test_config", str(cfg),
                  "--output_path", str(root / f"{tag}.json"),
                  "--stream_path", str(root / tag), "--rate_num", "1",
                  "--qp_i", str(QP), "--qp_p", str(QP), "--calc_ssim", "1",
                  "--verbose_json", "1", "--force_zero_thres", "0.12",
                  *extra])
            bins = root / tag / "ssim"
            out[tag] = {"bin": (bins / f"seq_q{QP}.bin").read_bytes(),
                        "log": json.loads(
                            (bins / f"seq_q{QP}.json").read_text())}
    return out


def test_ssim_case_bin_identical(logs):
    assert logs["port"]["bin"] == logs["jax"]["bin"]
    assert logs["port"]["log"]["frame_bpp"] == logs["jax"]["log"]["frame_bpp"]


def test_msssim_within_tolerance(logs):
    j, p = logs["jax"]["log"], logs["port"]["log"]
    keys = ["frame_msssim"] + [k for k in j if k.endswith("msssim")]
    for key in keys:
        for a, b in zip(np.atleast_1d(p[key]), np.atleast_1d(j[key])):
            assert 0 < b < 1 and abs(a - b) <= MSSSIM_ATOL, (key, a, b)


def test_psnr_within_tolerance_with_padding(logs):
    """The bound of test_torch_port_harness.py's `_psnr_tol`: every RGB
    sample moves by at most eps = 1e-4 * 255 * 2.86 code values, so the
    MSE by at most 2 eps rmse + eps^2."""
    eps = 1e-4 * 255 * (3 - 2 * 0.0722)
    j, p = logs["jax"]["log"], logs["port"]["log"]
    for a, b in zip(p["frame_psnr"], j["frame_psnr"]):
        rmse = 255.0 * 10 ** (-b / 20)
        tol = -10 * np.log10(1 - (2 * eps * rmse + eps * eps) / rmse ** 2)
        assert abs(a - b) <= tol
