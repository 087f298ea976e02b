"""The data axis on the CPU: `training/train.py::make_train_step(mesh=...)`
and `train_video` on 2 gloo ranks against one process on the whole batch.

  * one train step of each model train_video trains (DMCI, DMC with
    straight-through and with noise quantization, TCM, DCVC with noise),
    at its port init (seed 0), lambda 256, Adam at 1e-4 with the
    global-norm clip, on clips (4, 2, 64, 64, 3) from default_rng(0),
    through `parallel/dryrun.py::step_parity`: the loss within |dloss| <
    5e-4 max(1, |loss|) and the updated parameters within max|dparam| <
    5e-5 of the one-process step (the JAX dryrun's bounds,
    __graft_entry__.py:163 and :178), and bit-identical on both ranks.
    Two clips a rank: at one, the CPU backend's convolution backward sums
    in another order than at two, and Adam's first step, ~lr sign(g),
    turns that into up to 1.3 lr on coordinates whose gradient is near 0
    (the one-process DMC noise step on 1 and on 4 threads differs by
    1.07e-4 itself); the dryrun test holds one clip a rank;
  * `train_video --data_axis 2` on 2 ranks (OPENDCVC_TPU_DIST) writes
    the checkpoint one process writes at the same global batch (2 steps,
    no warmup, within the same bounds); a batch that the data axis does
    not divide raises ValueError on every rank.
"""

import os

import numpy as np
import pytest

from opendcvc_tpu_torch import train_video
from opendcvc_tpu_torch.parallel.dryrun import (LOSS_RTOL, PARAM_ATOL,
                                                check_parity, run_ranks,
                                                step_parity)
from opendcvc_tpu_torch.training.train import tree_leaves
from opendcvc_tpu_torch.utils import checkpoint as ckpt
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)
import torch_port_parallel_ranks as R

TIMEOUT = 240.0
SHAPE = (4, 2, 64, 64, 3)


@pytest.mark.parametrize("model,quant_mode", [
    ("dmci", "ste"), ("dmc", "ste"), ("dmc", "noise"), ("tcm", "ste"),
    ("dcvc", "noise")], ids=["dmci", "dmc", "dmc_noise", "tcm", "dcvc"])
def test_data_axis_step(model, quant_mode):
    res = step_parity(2, "cpu", model, (2, 1), shape=SHAPE,
                      quant_mode=quant_mode, timeout=TIMEOUT)
    print(model, quant_mode, {k: res[k] for k in
                              ("loss", "ref_loss", "dloss", "max_dparam")})
    check_parity(res)


ARGV = ["--device", "cpu", "--batch_size", "4", "--crop", "64",
        "--frames", "2", "--steps", "2", "--warmup_steps", "0",
        "--schedule", "constant", "--log_every", "1"]


def test_train_video_two_ranks(tmp_path, monkeypatch):
    monkeypatch.delenv("OPENDCVC_TPU_DIST", raising=False)
    one, two = tmp_path / "one", tmp_path / "two"
    want = train_video.main(ARGV + ["--save_dir", str(one)])
    ranks = run_ranks(2, R.train_video_rank,
                      (ARGV + ["--data_axis", "2", "--save_dir", str(two)],),
                      timeout=TIMEOUT)
    assert all(r["same"] for r in ranks)
    assert os.listdir(two) == ["dmc_latest.msgpack"]
    for got, ref in zip(ranks[0]["loss"],
                        [m["loss"] for m in want["metrics"]]):
        assert abs(got - ref) < LOSS_RTOL * max(1.0, abs(ref))
    a = ckpt.load_checkpoint(str(one / "dmc_latest.msgpack"))
    b = ckpt.load_checkpoint(str(two / "dmc_latest.msgpack"))
    assert int(a["extra"]["step"]) == int(b["extra"]["step"]) == 2
    worst = max(float(np.max(np.abs(np.asarray(x, np.float32)
                                    - np.asarray(y, np.float32))))
                for x, y in zip(tree_leaves(a["params"]),
                                tree_leaves(b["params"])))
    print("train_video, 2 ranks vs 1 process, max|dparam|:", worst)
    assert worst < PARAM_ATOL


def test_train_video_batch_must_split(tmp_path):
    ranks = run_ranks(2, R.train_video_rank,
                      (ARGV + ["--batch_size", "3", "--data_axis", "2",
                               "--save_dir", str(tmp_path)],),
                      timeout=TIMEOUT)
    assert [r[0] for r in ranks] == ["ValueError"] * 2
    assert "does not split" in ranks[0][1]
