"""The port's RD-artifact tools against the JAX package's (CPU).

  * `tools/make_synth_dataset_torch.py` at --seqs 2 --frames 3 --height 64
    --width 160 (wider than high, so the mirror tiling runs) writes the
    PNG bytes, config.json (its root_path aside) and printed lines of
    `tools/make_synth_dataset.py`;
  * `tools/bd_r5_torch.py --device cpu` and `tools/bd_r5.py` on the
    committed trained DMCI (`docs/dmci_tiny_rd.msgpack`), 4 QPs at
    128x192 on 2 images, host EC: the same JSON keys and text; every
    point's bpp_stream equal (the same bytes); PSNR within
    `test_torch_port_eval_extras.py::_psnr_tol`; the BD-rate against the
    anchor (recomputed unrounded from each JSON's points) within BD_SLACK
    x the first-order bound sum_i |d bd / d psnr_i| x _psnr_tol(psnr_i),
    the derivatives by central differences on the JAX points: the bound a
    move of each PSNR within its tolerance gives, with room for the
    second-order terms.  This checkpoint's PSNRs (about 21 dB) lie far
    below the anchor's, so that BD-rate extrapolates the cubic fits and
    it and its bound are huge; so the port's curve is also scored against
    the JAX package's (ranges that overlap), within the same bound of
    that BD-rate, which is 0 for equal curves;
  * both tools run with `jax` and `opendcvc_tpu` blocked from import.
"""

import importlib.util
import json
import os
import subprocess
import sys

from opendcvc_tpu_torch.eval.published_results import EVC_KODAK, bd_rate
from test_torch_port_eval_extras import _psnr_tol
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CKPT = os.path.join(ROOT, "docs", "dmci_tiny_rd.msgpack")
SYNTH_ARGS = ["--seqs", "2", "--frames", "3", "--height", "64",
              "--width", "160"]
BD_ARGS = ["--ckpt", TINY_CKPT, "--qps", "16,26,36,46", "--size", "128",
           "--width", "192", "--n_images", "2"]
BD_SLACK = 2.0
FD_STEP = 1e-3


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name + ".py"] + argv)
    _tool(name).main()


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_make_synth_dataset_matches_jax(tmp_path, monkeypatch, capsys):
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    _run_jax_tool("make_synth_dataset", ["--root", jroot] + SYNTH_ARGS,
                  monkeypatch)
    jout = capsys.readouterr().out
    _tool("make_synth_dataset_torch").main(["--root", proot] + SYNTH_ARGS)
    pout = capsys.readouterr().out
    assert pout == jout.replace(jroot, proot)
    jfiles, pfiles = _files(jroot), _files(proot)
    assert sorted(pfiles) == sorted(jfiles)
    assert len([n for n in pfiles if n.endswith(".png")]) == 6
    for name, data in jfiles.items():
        if name == "config.json":
            data = data.replace(jroot.encode(), proot.encode())
        assert pfiles[name] == data, name
    cfg = json.loads(pfiles["config.json"])
    seqs = cfg["test_classes"]["SYNTH"]["sequences"]
    assert all(s["width"] == 160 and s["height"] == 64
               for s in seqs.values())


def _bd(points, anchor=None):
    a = anchor or EVC_KODAK["EncL_DecL"]
    return float(bd_rate(a["bpp"], a["psnr"], points["bpp"],
                         points["psnr"]))


def _bd_bound(points, anchor=None):
    """sum_i |d bd / d psnr_i| x _psnr_tol(psnr_i), central differences
    in the scored curve's PSNRs."""
    total = 0.0
    for i, p in enumerate(points["psnr"]):
        hi, lo = list(points["psnr"]), list(points["psnr"])
        hi[i], lo[i] = p + FD_STEP, p - FD_STEP
        grad = (_bd({"bpp": points["bpp"], "psnr": hi}, anchor)
                - _bd({"bpp": points["bpp"], "psnr": lo}, anchor)) \
            / (2 * FD_STEP)
        total += abs(grad) * _psnr_tol(p)
    return total


def test_bd_r5_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
    monkeypatch.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
    jpath, ppath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    _run_jax_tool("bd_r5", BD_ARGS + ["--out", jpath], monkeypatch)
    _tool("bd_r5_torch").main(BD_ARGS + ["--out", ppath, "--device", "cpu"])
    print(capsys.readouterr().out)
    with open(jpath) as f:
        want = json.load(f)
    with open(ppath) as f:
        got = json.load(f)
    assert list(got) == list(want)
    assert got["anchor"] == want["anchor"]
    assert got["ours"] == want["ours"]
    assert got["anchor_points"] == want["anchor_points"]
    assert len(got["points"]) == len(want["points"]) == 4
    for g, w in zip(got["points"], want["points"]):
        assert list(g) == list(w)
        assert g["qp"] == w["qp"]
        assert g["bpp_stream"] == w["bpp_stream"]
        assert abs(g["psnr"] - w["psnr"]) <= _psnr_tol(w["psnr"]), (g, w)
    assert got["our_points"]["bpp"] == want["our_points"]["bpp"]
    bd_got, bd_want = _bd(got["our_points"]), _bd(want["our_points"])
    bound = BD_SLACK * _bd_bound(want["our_points"])
    print(f"BD-rate port {bd_got!r} JAX {bd_want!r} bound {bound!r}")
    assert abs(bd_got - bd_want) <= bound
    jax_curve = want["our_points"]
    bound = BD_SLACK * _bd_bound(jax_curve, jax_curve)
    cross = _bd(got["our_points"], jax_curve)
    print(f"BD-rate port vs JAX curve {cross!r} bound {bound!r}")
    assert abs(cross) <= bound
    for js, bd in ((got, bd_got), (want, bd_want)):
        assert js["bd_rate_vs_anchor_pct"] == round(bd, 1)


_CHILD = r"""
import sys
sys.modules["jax"] = None
sys.modules["opendcvc_tpu"] = None
sys.path.insert(0, sys.argv[1] + "/tools")
import make_synth_dataset_torch, bd_r5_torch
make_synth_dataset_torch.main(["--root", sys.argv[2] + "/ds", "--seqs", "1",
                               "--frames", "2", "--height", "64",
                               "--width", "64"])
out = bd_r5_torch.main(["--ckpt", sys.argv[1] + "/docs/dmci_tiny_rd.msgpack",
                        "--qps", "16,26,36,46", "--size", "64",
                        "--n_images", "1", "--device", "cpu",
                        "--out", sys.argv[2] + "/bd.json"])
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "opendcvc_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("OK", len(out["points"]))
"""


def test_tools_run_without_jax(tmp_path):
    env = dict(os.environ, OPENDCVC_TPU_RANS_THREADS="0")
    env.pop("OPENDCVC_TPU_DEVICE_EC", None)
    res = subprocess.run([sys.executable, "-c", _CHILD, ROOT, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK 4"), res.stdout[-2000:]
