"""The spatial axis on the CPU: `opendcvc_tpu_torch/parallel/spatial.py`'s
halo exchange through `layers/blocks.py::conv_apply`, on gloo ranks.

  * each of DCVC-RT's padded convolutions (3x3 at stride 1 and 2, the
    depthwise 3x3, the subpel 2x) on a frame split in height over 2 and
    4 ranks: each rank's output rows and its rows of the input's gradient
    equal the unsplit convolution's, and the weight and bias gradients
    summed over the ranks equal the unsplit ones, within 1e-5 of each
    tensor's largest |value| (float32; the split runs the same windows,
    only the backend's summation layout differs);
  * DMC's decode stages (_stage_feature, then _stage_recon_x, full width)
    on a 128x64 frame split over 2 ranks, the small-frame counterpart of
    tests/test_parallel.py:64: the frame within the JAX test's 2e-5, the
    gradients of y_hat, ctx and every parameter within 2e-4 of their
    largest |value| (GRAD_RTOL of tests/test_torch_port_training.py);
  * what raises: a shard that is not a multiple of 64 rows, and TCM, FM
    and DCVC on a split frame; and a noise draw under a shard is the
    shard's block of the global draw, exactly.
"""

import numpy as np
import pytest
import torch

from opendcvc_tpu_torch.parallel import mesh as M
from opendcvc_tpu_torch.parallel.dryrun import run_ranks
from opendcvc_tpu_torch.training import forward as PF
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)
import torch_port_parallel_ranks as R

TIMEOUT = 240.0
HALO_RTOL = 1e-5
DEC_FWD_TOL = 2e-5
GRAD_RTOL = 2e-4


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def halo_run(request):
    sp = request.param
    return sp, run_ranks(sp, R.halo_rank, (sp,), timeout=TIMEOUT)


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("case", sorted(R.HALO_CASES))
def test_halo_conv(case, halo_run):
    sp, ranks = halo_run
    x, w, b, r = R.halo_inputs(case, sp)
    out, gx, gw, gb = (t.numpy() for t in R.halo_grads(case, x, w, b, r))
    ho, hx = out.shape[2] // sp, x.shape[2] // sp
    for s, res in enumerate(ranks):
        o, g, sgw, sgb = res[case]
        _close(o, out[:, :, s * ho:(s + 1) * ho], HALO_RTOL)
        _close(g, gx[:, :, s * hx:(s + 1) * hx], HALO_RTOL)
        _close(sgw, gw, HALO_RTOL)
        _close(sgb, gb, HALO_RTOL)


def test_decode_stages_split():
    errs = run_ranks(2, R.decode_rank, (2,), timeout=TIMEOUT)[0]
    print("decode stages, spatial 2, error / max|ref|:", errs)
    assert errs["x_hat"] < DEC_FWD_TOL, errs
    for k in ("y_hat_grad", "ctx_grad", "param_grad"):
        assert errs[k] < GRAD_RTOL, errs


def _fake_shard(dp=1, d=0, sp=2, s=1):
    mesh = M.Mesh({"data": dp, "spatial": sp}, {"data": d, "spatial": s},
                  {"data": list(range(dp)), "spatial": list(range(sp))},
                  {"data": None, "spatial": None})
    return M.Shard(mesh, spatial=True)


@pytest.mark.parametrize("what", ["dmci", "dmc"])
def test_split_needs_64_rows(what):
    """A shard of 32 rows raises before any exchange."""
    x = torch.zeros(1, 32, 64, 3)
    with M.sharded(_fake_shard()), pytest.raises(ValueError,
                                                 match="multiples of 64"):
        if what == "dmci":
            PF.dmci_forward({}, x, 21)
        else:
            PF.dmc_forward_one_frame({}, x, x, None, 21)


@pytest.mark.parametrize("what", ["tcm", "fm", "dcvc"])
def test_split_refuses_warps(what):
    x = torch.zeros(1, 64, 64, 3)
    fn = {"tcm": lambda: PF.dmc_tcm_forward_one_frame({}, x, x, None),
          "fm": lambda: PF.dmc_fm_forward_one_frame(
              {}, x, x, None, None, None, None, 0),
          "dcvc": lambda: PF.dcvc_forward({}, x, x)}[what]
    with M.sharded(_fake_shard()), pytest.raises(ValueError,
                                                 match="warps gather"):
        fn()


def test_noise_block():
    """Under a Shard (data 2, spatial 2; this rank d 1, s 0) the noise is
    the block of the global draw from the same generator state."""
    x = torch.zeros(3, 4, 2, 5)
    want = torch.rand((6, 4, 4, 5), generator=torch.Generator()
                      .manual_seed(7)) - 0.5
    with M.sharded(_fake_shard(dp=2, d=1, sp=2, s=0)):
        got = PF.quant_noise(x, torch.Generator().manual_seed(7))
    assert torch.equal(got, want[3:6, :, 0:2])
