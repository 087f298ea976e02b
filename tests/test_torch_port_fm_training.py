"""The port's DCVC-FM training forward and loss
(`training/forward.py::dmc_fm_forward_one_frame`,
`training/train.py::make_fm_loss`) against the JAX package's, on the CPU.

Weights: the JAX package's `DMCFM().init_params(seed=1)`, carried across
by from_jax; a 3-frame clip (two P-frames) of 64x64 frames from numpy
(default_rng), batch 2, q_index 30, lambda 32 .. 4096, quant_mode "ste".
Held, with the tolerances of tests/test_torch_port_training.py and
tests/test_torch_port_tcm.py and their reasons:
  * the loss and the loss's metrics within FWD_RTOL relative;
  * every output of each frame's forward: the rates and distortions
    within FWD_RTOL relative, x_hat and the four propagated DPB entries
    (feature, mv_feature, y_hat, mv_y_hat) within FWD_RTOL x max|ref|;
  * the gradients through both frames' DPB chain, each leaf's error
    taken relative to max(its largest |value|, GRAD_FLOOR x the tree's
    largest |value|): all but at most KINK_LEAVES of the 762 leaves
    within GRAD_RTOL, and every leaf within GRAD_KINK.  The reason: FM's
    gradient is piecewise in its floats (LeakyReLU's slope switches at 0,
    the bilinear warps' cell at each integer coordinate), so where a
    value lies within float noise of a kink, a change in summation order
    alone moves a gradient leaf by more than GRAD_RTOL.  When this test
    was written, the port at one thread against itself at eight differed
    on 6 leaves by more than GRAD_RTOL, up to 2.1e-3 (at
    /y_spatial_prior/[1]/ffn/c1/w, and up to 9.6e-4 at /align/off2/w);
    the port at one thread against JAX on 10 leaves, up to 2.1e-3 (the
    same leaf and value); at eight threads against JAX on 5, up to
    5.4e-4.  The forward, whose values are continuous there, holds
    FWD_RTOL; the steady-state adaptors (feature_adaptor[1], the fusion
    adaptors _1) and the quant anchors learn;
  * the port's train step on the FM loss, float32 and AMP: finite loss,
    float32 parameters and Adam state.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from opendcvc_tpu.models.dmc_fm import DMCFM as JDMCFM
from opendcvc_tpu.training import forward as JF
from opendcvc_tpu.training import train as JT
from opendcvc_tpu_torch.training import forward as PF
from opendcvc_tpu_torch.training import train as PT
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

B, T, HW, QI = 2, 3, 64, 30
LMBDA_MIN, LMBDA_MAX = 32.0, 4096.0
FWD_RTOL = 1e-4
GRAD_RTOL = 2e-4
GRAD_FLOOR = 1e-5
GRAD_KINK = 5e-3
KINK_LEAVES = 16
DPB = ("x_hat", "feature", "mv_feature", "y_hat", "mv_y_hat")
RATES = ("mse", "warp_mse", "bpp_y", "bpp_z", "bpp_mv_y", "bpp_mv_z", "bpp")


@pytest.fixture(scope="module")
def jp():
    return JDMCFM().init_params(seed=1)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(11).random((B, T, HW, HW, 3), np.float32)


def _jax_loss_and_frames(p, f):
    """make_fm_loss's loss and metrics, and each frame's forward outputs
    on the same cascade."""
    key = jax.random.PRNGKey(0)
    loss, metrics = JT.make_fm_loss(LMBDA_MIN, LMBDA_MAX)(
        p, f, jnp.int32(QI), key)
    outs, ref, dpb = [], f[:, 0], (None,) * 4
    for t in range(1, T):
        o = JF.dmc_fm_forward_one_frame(p, f[:, t], ref, *dpb,
                                        jnp.int32(QI), key, fa_idx=t - 1)
        outs.append(o)
        ref = o["x_hat"]
        dpb = (o["feature"], o["mv_feature"], o["y_hat"], o["mv_y_hat"])
    return loss, (metrics, outs)


@pytest.fixture(scope="module")
def run(jp, frames):
    (loss, (metrics, outs)), grads = jax.jit(jax.value_and_grad(
        _jax_loss_and_frames, has_aux=True))(jp, jnp.asarray(frames))
    params = from_jax(jp)
    leaves = PT.tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    x = torch.from_numpy(frames)
    p_loss, p_metrics = PT.make_fm_loss(LMBDA_MIN, LMBDA_MAX)(params, x, QI,
                                                              None)
    p_grads = torch.autograd.grad(p_loss, leaves, allow_unused=True)
    p_outs, ref, dpb = [], x[:, 0], (None,) * 4
    with torch.no_grad():
        for t in range(1, T):
            o = PF.dmc_fm_forward_one_frame(params, x[:, t], ref, *dpb, QI,
                                            fa_idx=t - 1)
            p_outs.append(o)
            ref = o["x_hat"]
            dpb = (o["feature"], o["mv_feature"], o["y_hat"], o["mv_y_hat"])
    return {"jax": (loss, metrics, outs, from_jax(grads)),
            "port": (p_loss, p_metrics, p_outs, PT.tree_unflatten(params, [
                torch.zeros_like(t) if g is None else g
                for t, g in zip(leaves, p_grads)]))}


def _rel(got, want, what):
    got, want = float(got), float(want)
    print(f"{what}: port {got:.7g}, JAX {want:.7g}")
    assert abs(got - want) <= FWD_RTOL * abs(want), what


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy() if t.shape[-1] != 3 \
        else t.detach().numpy()


def test_fm_loss_and_metrics_match(run):
    loss, metrics, _, _ = run["jax"]
    p_loss, p_metrics, _, _ = run["port"]
    assert set(p_metrics) == set(metrics)
    for k, want in metrics.items():
        _rel(p_metrics[k].detach(), want, k)
    _rel(p_loss.detach(), loss, "loss")


@pytest.mark.parametrize("frame", [0, 1], ids=["first_p", "steady_p"])
def test_fm_forward_outputs_match(run, frame):
    """Frame 1 codes from the pixel reference (adaptor I, fusion adaptors
    0), frame 2 from frame 1's DPB (feature_adaptor[1], fusion adaptors
    1)."""
    want = run["jax"][2][frame]
    got = run["port"][2][frame]
    assert set(got) == set(want)
    for k in RATES:
        _rel(got[k], want[k], f"frame {frame + 1} {k}")
    for k in DPB:
        ref = np.asarray(want[k], np.float32)
        diff = np.abs(_nhwc(got[k]) - ref).max()
        print(f"frame {frame + 1} {k}: max diff {diff:.3g} of "
              f"max|ref| {np.abs(ref).max():.3g}")
        np.testing.assert_allclose(_nhwc(got[k]), ref, rtol=0,
                                   atol=FWD_RTOL * float(np.abs(ref).max()),
                                   err_msg=k)


def _pairs(port, ref, path=""):
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        return [x for k in port for x in _pairs(port[k], ref[k],
                                                f"{path}/{k}")]
    if isinstance(port, (list, tuple)):
        assert len(port) == len(ref), path
        return [x for i, (a, b) in enumerate(zip(port, ref))
                for x in _pairs(a, b, f"{path}/[{i}]")]
    return [(path, port, ref)]


def test_fm_gradients_match(run):
    pairs = _pairs(run["port"][3], run["jax"][3])
    floor = GRAD_FLOOR * max(float(w.abs().max()) for _, _, w in pairs)
    errs = sorted(((float((g - w).abs().max()
                          / max(float(w.abs().max()), floor)), path)
                   for path, g, w in pairs), reverse=True)
    kinked = [(e, p) for e, p in errs if e > GRAD_RTOL]
    print(f"{len(kinked)} of {len(errs)} leaves beyond GRAD_RTOL: "
          + ", ".join(f"{p} {e:.3g}" for e, p in kinked))
    assert errs[0][0] <= GRAD_KINK, errs[0]
    assert len(kinked) <= KINK_LEAVES, kinked
    by_path = {p: g for p, g, _ in pairs}
    for path in ("/feature_adaptor/[1]/w", "/mv_fusion_adaptor_1/dc/conv1/w",
                 "/y_fusion_adaptor_1/dc/conv1/w", "/y_q_enc",
                 "/mv_y_q_dec"):
        assert float(by_path[path].abs().sum()) > 0, path


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "amp"])
def test_fm_train_step_on_cpu(jp, frames, amp):
    """Two steps of make_train_step on the FM loss: finite losses; the
    parameters and Adam's state stay float32 and move."""
    params = from_jax(jp)
    tx = PT.make_optimizer(1e-4)
    state = tx.init(PT.trainable_leaves(params))
    step = PT.make_train_step(PT.make_fm_loss(LMBDA_MIN, LMBDA_MAX), tx,
                              compute_dtype=torch.bfloat16 if amp else None)
    first = [t.clone() for t in PT.tree_leaves(params)]
    x = torch.from_numpy(frames[:1])
    for _ in range(2):
        params, state, metrics = step(params, state, x, QI, None)
        assert np.isfinite(float(metrics["loss"]))
    for t in PT.tree_leaves(params) + state["mu"] + state["nu"]:
        assert t.dtype == torch.float32
    assert any(not torch.equal(a, b) for a, b in
               zip(first, PT.tree_leaves(params)))
