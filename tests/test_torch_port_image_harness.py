"""The port's image harness (`python -m
opendcvc_tpu_torch.eval.image_harness`) against the JAX package's
(`opendcvc_tpu.eval.image_harness`), on the CPU.

Two PNGs, 64x96 and 80x64 (so both are padded to 64), of a smooth
gradient plus mild noise (numpy seeds), in one Kodak-style config, and a
96x88 one (MS-SSIM needs 88 pixels a side) in another.  Both
harnesses code them with the same weights: the JAX package's EVC_SS
`init_params(0)` with its q_scale anchors spread to [2.0, 1.2, 0.8, 0.5]
(the init's anchors are all ones, between which no ladder spans), saved by
its `save_params` and read by the port's JAX-free checkpoint reader.  The
JAX codec codes with its plain coder (OPENDCVC_TPU_FORCE_PY_RANS=1).  Two
runs: the two images at --rate_num 2 (a ladder between the anchors), and
the 96x88 one at --q_scales 1.5 0.6 with --calc_ssim 1.
Held: the .bin files are byte-identical; the JSON has the same keys in
the same order and equal bpp and q_scale; PSNR within the bound
`test_torch_port_harness.py::_psnr_tol` derives from the codecs' float
agreement (x_hat within X_HAT_ATOL), MS-SSIM within
`test_torch_port_harness_ssim.py`'s MSSSIM_ATOL.  Also: the default
--device cuda raises without CUDA, and reading a PNG without PIL raises
a clear ImportError.
"""

import json
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from opendcvc_tpu.eval import image_harness as JH
from opendcvc_tpu.models import evc as JE
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.eval import image_harness as PH
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

IMAGES = {"a.png": (64, 96), "b.png": (80, 64)}
SSIM_IMAGES = {"c.png": (96, 88)}
ANCHORS = [2.0, 1.2, 0.8, 0.5]
# the codecs' floats agree within 1e-4 * max|ref| (test_torch_port_evc),
# and x_hat lies in [0, 1]
X_HAT_ATOL = 1e-4
MSSSIM_ATOL = 1e-4
#: run -> (its images, its options)
RUNS = {"rate_num": (IMAGES, ["--rate_num", "2"]),
        "q_scales": (SSIM_IMAGES, ["--q_scales", "1.5", "0.6",
                                   "--calc_ssim", "1"])}


def _psnr_tol(psnr, eps):
    """Largest PSNR change when every sample moves by at most eps (code
    values): with rmse from the PSNR, the MSE moves by at most
    2 eps rmse + eps^2."""
    rmse = 255.0 * 10 ** (-psnr / 20)
    delta = (2 * eps * rmse + eps * eps) / (rmse * rmse)
    return -10 * math.log10(1 - delta)


def _write_images(root):
    """Every image under root/imgs; a config per run, by run name."""
    rng = np.random.default_rng(5)
    os.makedirs(os.path.join(root, "imgs"), exist_ok=True)
    for name, (h, w) in {**IMAGES, **SSIM_IMAGES}.items():
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx / w, yy / h, (xx + yy) / (h + w)], -1) * 255
        img = np.clip(base + rng.normal(0, 12, base.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(root, "imgs", name))
    cfgs = {}
    for run, (images, _) in RUNS.items():
        cfgs[run] = os.path.join(root, f"{run}.json")
        with open(cfgs[run], "w") as f:
            json.dump({"root_path": root, "test_classes": {"kodak": {
                "test": 1, "base_path": "imgs", "images": list(images)}}},
                f)
    return cfgs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("image_harness"))
    cfg = _write_images(root)
    tree = JE.EVC_SS().init_params(seed=0)
    tree["q_scale"] = jnp.asarray(ANCHORS, jnp.float32)
    ckpt = os.path.join(root, "evc_ss.msgpack")
    JCK.save_params(ckpt, tree)
    return root, cfg, ckpt


def _bins(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.fixture(scope="module", params=list(RUNS))
def run(request, setup):
    root, cfgs, ckpt = setup
    images, opts = RUNS[request.param]
    out = {"images": images}
    for side, mod in (("jax", JH), ("port", PH)):
        d = os.path.join(root, request.param, side)
        argv = ["--model_type", "EVC_SS", "--model_path", ckpt,
                "--test_config", cfgs[request.param],
                "--stream_path", os.path.join(d, "bin"),
                "--output_path", os.path.join(d, "out.json")] \
            + opts + (["--device", "cpu"] if side == "port" else [])
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
            mod.main(argv)
        with open(os.path.join(d, "out.json")) as f:
            out[side] = {"json": json.load(f),
                         "bins": _bins(os.path.join(d, "bin"))}
    return out


def test_bins_byte_identical(run):
    j, p = run["jax"]["bins"], run["port"]["bins"]
    assert list(p) == list(j) and len(p) == 2 * len(run["images"])
    for name in j:
        assert p[name] == j[name], name


def test_json_layout_and_bpp(run):
    j, p = run["jax"]["json"], run["port"]["json"]
    assert list(p) == list(j) == ["kodak"]
    assert list(p["kodak"]) == list(j["kodak"]) == list(run["images"])
    for img, (h, w) in run["images"].items():
        assert list(p["kodak"][img]) == list(j["kodak"][img]) == \
            ["000", "001"]
        for ri, row in p["kodak"][img].items():
            ref = j["kodak"][img][ri]
            assert list(row) == list(ref)
            assert row["bpp"] == ref["bpp"] > 0
            assert row["q_scale"] == ref["q_scale"]
            bits = len(run["port"]["bins"][f"{img}_{int(ri)}.bin"]) * 8
            assert row["bpp"] == pytest.approx(bits / (h * w), abs=1e-6)


def test_psnr_and_msssim_within_tolerance(run):
    j, p = run["jax"]["json"], run["port"]["json"]
    ssim = run["images"] is SSIM_IMAGES
    for img in run["images"]:
        for ri, row in p["kodak"][img].items():
            ref = j["kodak"][img][ri]
            assert np.isfinite(row["psnr"])
            assert abs(row["psnr"] - ref["psnr"]) <= _psnr_tol(
                ref["psnr"], X_HAT_ATOL * 255), (img, ri)
            if ssim:
                assert 0 < ref["msssim"] < 1
            assert abs(row["msssim"] - ref["msssim"]) <= MSSSIM_ATOL


def test_registry_equals_jax():
    assert list(PH.MODEL_REGISTRY) == list(JH.MODEL_REGISTRY)
    for name, cls in PH.MODEL_REGISTRY.items():
        assert cls.__name__ == JH.MODEL_REGISTRY[name].__name__


def test_default_device_cuda_raises_without_cuda(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    _, cfgs, _ = setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PH.main(["--test_config", cfgs["rate_num"], "--output_path",
                 str(tmp_path / "o.json"), "--stream_path",
                 str(tmp_path / "bin")])
    assert not (tmp_path / "bin").exists()


def test_read_image_without_pil_raises(setup, monkeypatch):
    root, _, _ = setup
    path = os.path.join(root, "imgs", "a.png")
    img = PH.read_image(path)
    assert img.shape == IMAGES["a.png"] + (3,) and img.dtype == np.float32
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        PH.read_image(path)
