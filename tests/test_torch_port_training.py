"""The port's DCVC-RT training (`opendcvc_tpu_torch/training`,
`train_video.py`, the checkpoint writer) against the JAX package's, on the
CPU, float32 unless stated.

Weights: the JAX package's `dmci_init(PRNGKey(0), **TINY_KW)` (a
reduced-width DMCI, as tests/test_torch_port_trained.py uses) and
`dmc_init(PRNGKey(1))` (DMC's fixed widths), carried across by from_jax;
32x32 frames from numpy (default_rng), batch 2, qp 21, lambda 256.
Tolerances, each with its reason:
  * rate terms: bits within 1e-3 + 1e-5 |bits|: the packages' float32
    erf, erfc and sigmoid differ by an ulp or two;
  * forwards: mse, bpp_y, bpp_z within 1e-4 relative, x_hat and the
    feature within 1e-4 * max|ref| (the codecs' float agreement,
    tests/test_torch_port_codec.py);
  * gradients: each leaf within GRAD_RTOL = 2e-4 of its largest |value|
    (measured 1.2e-5 DMCI, 2.3e-5 DMC): one backward pass sums the
    forward's 1e-6-relative differences over many paths, and
    straight-through rounding keeps them from growing;
  * three optimizer steps (cosine schedule, 1 warmup step, so the first
    update has lr 0, global-norm clipping active): each parameter within
    6 lr of the JAX package's.  Adam divides by sqrt(v) + 1e-8, so where
    a gradient is near 1e-8 its ~1e-6 relative difference becomes a
    difference of up to lr a step (2 lr when the sign flips); 99 % of the
    values must agree within lr / 100;
  * global-norm clipping, with the clip above and below the norm: Adam's
    first moment after one update within 1e-6 relative of optax's (the
    packages sum the squares in different orders);
  * AMP (bfloat16 compute): the loss within 0.5 % of the JAX package's
    bfloat16 loss (measured 0.04 %: bfloat16 carries 8 bits, the packages
    round their convolutions' sums differently, and the rate terms, most
    of this loss, are float32 on both sides); the distortion is computed
    in bfloat16; gradients, parameters and Adam's moments stay float32;
  * schedules within 1e-6 relative at every step (optax computes in
    float32); batches of the data pipelines, checkpoint bytes and the
    freeze hook's zeros exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from opendcvc_tpu.entropy import models as JE
from opendcvc_tpu.eval.rd_evidence import TINY_KW
from opendcvc_tpu.models.dmc import dmc_init as jax_dmc_init
from opendcvc_tpu.models.dmci import dmci_init as jax_dmci_init
from opendcvc_tpu.training import data as JDATA
from opendcvc_tpu.training import forward as JF
from opendcvc_tpu.training import train as JT
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch import train_video
from opendcvc_tpu_torch.entropy import models as PE
from opendcvc_tpu_torch.training import data as PDATA
from opendcvc_tpu_torch.training import forward as PF
from opendcvc_tpu_torch.training import train as PT
from opendcvc_tpu_torch.utils import checkpoint as PCK
from opendcvc_tpu_torch.utils.params import from_jax, to_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

HW, B, QP, LMBDA = 32, 2, 21, 256.0
FWD_RTOL = 1e-4
GRAD_RTOL = 2e-4
LR = 1e-4
AMP_RTOL = 5e-3


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _close(got, ref, rtol=FWD_RTOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rtol * float(np.abs(ref).max()))


def _rel(got, ref, rtol=FWD_RTOL):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else \
        float(got)
    assert abs(got - float(ref)) <= rtol * abs(float(ref)), (got,
                                                             float(ref))


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).random((B, 3, HW, HW, 3), np.float32)


@pytest.fixture(scope="module")
def jp_i():
    return jax_dmci_init(jax.random.PRNGKey(0), **TINY_KW)


@pytest.fixture(scope="module")
def jp_p():
    return jax_dmc_init(jax.random.PRNGKey(1))


def _grads(loss, params):
    """d loss / d leaf as a tree shaped as `params` (zeros where unused)."""
    leaves = PT.tree_leaves(params)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return PT.tree_unflatten(params, [
        torch.zeros_like(t) if g is None else g for t, g in zip(leaves, got)])


def _pairs(port, ref, path=""):
    """(key path, port leaf, JAX leaf in the port's layout) of two trees
    matched by key (JAX's tree utilities sort dict keys, the port keeps
    the init's order)."""
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        return [x for k in port for x in _pairs(port[k], ref[k],
                                                f"{path}/{k}")]
    if isinstance(port, (list, tuple)):
        assert len(port) == len(ref), path
        return [x for i, (a, b) in enumerate(zip(port, ref))
                for x in _pairs(a, b, f"{path}/[{i}]")]
    return [(path, port, ref)]


def _trainable(jp):
    params = from_jax(jp)
    for t in PT.tree_leaves(params):
        t.requires_grad_()
    return params


def _jax_dmci_vg(p, x, rng, mode):
    out = JF.dmci_forward(p, x, QP, rng, mode)
    return JT.rd_loss(out, LMBDA), out


_J_DMCI_VG = jax.jit(jax.value_and_grad(_jax_dmci_vg, has_aux=True),
                     static_argnums=3)


@pytest.fixture(scope="module")
def dmci_run(jp_i, frames):
    x = frames[:, 0]
    (loss, out), grads = _J_DMCI_VG(jp_i, jnp.asarray(x),
                                    jax.random.PRNGKey(0), "ste")
    params = _trainable(jp_i)
    p_loss, p_metrics = PT.make_dmci_loss(LMBDA)(params, torch.from_numpy(x),
                                                 QP, None)
    return {"jax": (loss, out, from_jax(grads)),
            "port": (p_loss, p_metrics, _grads(p_loss, params)),
            "port_out": PF.dmci_forward(params, torch.from_numpy(x), QP)}


def test_rate_terms_match(jp_i):
    rng = np.random.default_rng(1)
    z = np.round(rng.normal(0, 3, (B, 2, 2, 64))).astype(np.float32)
    want = JE.bit_estimator_bits(jp_i["bit_estimator_z"], jnp.asarray(z), QP)
    got = PE.bit_estimator_bits(from_jax(jp_i)["bit_estimator_z"],
                                _nchw(z), QP).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)
    y = np.round(rng.normal(0, 4, (4, 8, 8, 16))).astype(np.float32)
    s = np.exp(rng.uniform(-4, 3, y.shape)).astype(np.float32)
    want = JE.gaussian_bits(jnp.asarray(y), jnp.asarray(s))
    got = PE.gaussian_bits(_nchw(y), _nchw(s)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)
    assert PE.gaussian_bits(_nchw(y).bfloat16(), _nchw(s)).dtype == \
        torch.float32


def test_dmci_forward_matches(dmci_run):
    loss, out, _ = dmci_run["jax"]
    p_loss, metrics, _ = dmci_run["port"]
    for k in ("mse", "bpp_y", "bpp_z", "bpp"):
        _rel(metrics[k], out[k])
    _rel(p_loss, loss)
    _close(dmci_run["port_out"]["x_hat"].detach(), out["x_hat"])


def test_dmci_gradients_match(dmci_run):
    pairs = _pairs(dmci_run["port"][2], dmci_run["jax"][2])
    for path, g, w in pairs:
        _close(g, w, GRAD_RTOL)
    assert sum(float(g.abs().sum()) for _, g, _ in pairs) > 0


def test_dmci_noise_mode_with_jax_noise(jp_i, frames):
    """quant_mode "noise": the JAX package's uniform draw for z (its
    split(rng, 2)[0]) passed to the port as the noise tensor."""
    x = frames[:, 0]
    rng = jax.random.PRNGKey(3)
    out = jax.jit(JF.dmci_forward, static_argnums=4)(
        jp_i, jnp.asarray(x), QP, rng, "noise")
    noise = jax.random.uniform(jax.random.split(rng, 2)[0],
                               (B, 1, 1, TINY_KW["z_channel"]), jnp.float32,
                               -0.5, 0.5)
    with torch.no_grad():
        got = PF.dmci_forward(from_jax(jp_i), torch.from_numpy(x), QP,
                              _nchw(noise), "noise")
    for k in ("mse", "bpp_y", "bpp_z"):
        _rel(got[k], out[k])
    _close(got["x_hat"], out["x_hat"])


def _jax_dmc_vg(p, frames):
    """make_dmc_loss (T = 3: two P-frames) and each frame's forward."""
    loss, metrics = JT.make_dmc_loss(LMBDA)(p, frames, QP,
                                            jax.random.PRNGKey(0))
    outs, ref, feat = [], frames[:, 0], None
    for t in (1, 2):
        o = JF.dmc_forward_one_frame(p, frames[:, t], ref, feat, QP,
                                     jax.random.PRNGKey(t))
        outs.append(o)
        ref, feat = o["x_hat"], o["feature"]
    return loss, (metrics, outs)


@pytest.fixture(scope="module")
def dmc_run(jp_p, frames):
    (loss, (metrics, outs)), grads = jax.jit(jax.value_and_grad(
        _jax_dmc_vg, has_aux=True))(jp_p, jnp.asarray(frames))
    params = _trainable(jp_p)
    p_loss, p_metrics = PT.make_dmc_loss(LMBDA)(
        params, torch.from_numpy(frames), QP, None)
    return {"jax": (loss, metrics, outs, from_jax(grads)),
            "port": (p_loss, p_metrics, _grads(p_loss, params))}


def test_dmc_forwards_match(jp_p, frames, dmc_run):
    """dmc_forward_one_frame from the pixel reference, then from the
    feature; make_dmc_loss's loss and metrics."""
    loss, metrics, outs, _ = dmc_run["jax"]
    p_loss, p_metrics, _ = dmc_run["port"]
    _rel(p_loss, loss)
    for k in ("mse", "bpp"):
        _rel(p_metrics[k], metrics[k])
    params = from_jax(jp_p)
    ref, feat = torch.from_numpy(frames[:, 0]), None
    with torch.no_grad():
        for t, want in zip((1, 2), outs):
            got = PF.dmc_forward_one_frame(params,
                                           torch.from_numpy(frames[:, t]),
                                           ref, feat, QP)
            for k in ("mse", "bpp_y", "bpp_z"):
                _rel(got[k], want[k])
            _close(got["x_hat"], want["x_hat"])
            _close(got["feature"].permute(0, 2, 3, 1), want["feature"])
            ref, feat = got["x_hat"], got["feature"]


def test_dmc_gradients_match(dmc_run):
    """Through the feature chain of two P-frames (x_hat and feature not
    detached between frames)."""
    pairs = _pairs(dmc_run["port"][2], dmc_run["jax"][3])
    for path, g, w in pairs:
        _close(g, w, GRAD_RTOL)
    # frame 2 codes from frame 1's feature: the P adaptor learns
    assert float(dict((p, g) for p, g, _ in pairs)[
        "/feature_adaptor_p/w"].abs().sum()) > 0


def test_batch_of_8_equals_single_frames(jp_i, jp_p):
    """Every stage at B = 8 against the same samples one by one: x_hat,
    feature and per-sample rates (bpp sums over the batch)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random((8, HW, HW, 3), np.float32))
    ref = torch.from_numpy(rng.random((8, HW, HW, 3), np.float32))
    pi, pp = from_jax(jp_i), from_jax(jp_p)
    with torch.no_grad():
        runs = [("dmci", lambda s: PF.dmci_forward(pi, x[s], QP)),
                ("dmc", lambda s: PF.dmc_forward_one_frame(
                    pp, x[s], ref[s], None, QP))]
        for name, run in runs:
            whole = run(slice(0, 8))
            ones = [run(slice(i, i + 1)) for i in range(8)]
            for k in ["x_hat"] + (["feature"] if name == "dmc" else []):
                _close(whole[k], torch.cat([o[k] for o in ones]))
            for k in ("bpp_y", "bpp_z"):
                _rel(whole[k], sum(float(o[k]) for o in ones))
            _rel(whole["mse"], np.mean([float(o["mse"]) for o in ones]))


SCHEDULES = [("constant", {}), ("step", {"step_size": 4, "gamma": 0.5}),
             ("multistep", {"milestones": [3, 7], "gamma": 0.5}),
             ("cosine", {"min_ratio": 0.1})]


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("kind,kw", SCHEDULES,
                         ids=[k for k, _ in SCHEDULES])
def test_schedules_match_optax(kind, kw, warmup):
    """Every step from 0 to past the last boundary (total 12)."""
    want = JT.make_schedule(kind, LR, 12, warmup, **kw)
    got = PT.make_schedule(kind, LR, 12, warmup, **kw)
    for count in range(20):
        w = float(want(jnp.int32(count)))
        assert abs(got(count) - w) <= 1e-6 * LR, (count, got(count), w)
    if warmup:
        assert got(0) == 0.0


def _optax_steps(jp, x, n):
    """n steps of the JAX package's update (make_train_step's body)."""
    tx = JT.make_optimizer(LR, "cosine", 10, 1, 1.0)

    @jax.jit
    def apply(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params,
                                      updates), state

    state, params = tx.init(jp), jp
    for _ in range(n):
        (_, _), grads = _J_DMCI_VG(params, x, jax.random.PRNGKey(0), "ste")
        params, state = apply(grads, state, params)
    return params


def test_three_optimizer_steps_match(jp_i, frames):
    """make_train_step(make_dmci_loss, make_optimizer): cosine over 10
    steps after 1 warmup step (lr 0 at the first update), global-norm
    clip 1.0 (random weights' gradients exceed it, so it scales)."""
    x = frames[:, 0]
    want = from_jax(_optax_steps(jp_i, jnp.asarray(x), 3))
    params = from_jax(jp_i)
    tx = PT.make_optimizer(LR, "cosine", 10, 1, 1.0)
    step = PT.make_train_step(PT.make_dmci_loss(LMBDA), tx)
    state = tx.init(PT.tree_leaves(params))
    first = [t.clone() for t in PT.tree_leaves(params)]
    for i in range(3):
        params, state, metrics = step(params, state, torch.from_numpy(x), QP,
                                      None)
        if i == 0:      # lr 0: the moments move, the parameters do not
            assert all(torch.equal(a, b) for a, b in
                       zip(first, PT.tree_leaves(params)))
            assert float(state["mu"][0].abs().sum()) > 0
    diffs = []
    for path, g, w in _pairs(params, want):
        d = (g.detach() - w).abs()
        assert float(d.max()) <= 6 * LR, path
        diffs.append(d.reshape(-1))
    d = torch.cat(diffs)
    assert float((d <= LR / 100).float().mean()) >= 0.99
    moved = torch.cat([(a - b.detach()).abs().reshape(-1) for a, b in
                       zip(first, PT.tree_leaves(params))])
    assert float(moved.max()) > LR / 2


@pytest.mark.parametrize("ratio", [0.5, 2.0], ids=["scaled", "kept"])
def test_clip_matches_optax(ratio):
    """clip_by_global_norm at a clip of `ratio` x the gradients' global
    norm: Adam's first moment after one update is (1 - b1) x the clipped
    gradient, within 1e-6 relative of optax's."""
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((4, 3), (7,), (2, 2, 5))]
    clip = ratio * float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                     for g in grads)))
    jtx = JT.make_optimizer(LR, grad_clip=clip)
    jg = [jnp.asarray(g) for g in grads]
    _, jstate = jtx.update(jg, jtx.init(jg), jg)
    want = jstate[1][0].mu
    tx = PT.make_optimizer(LR, grad_clip=clip)
    tg = [torch.from_numpy(g) for g in grads]
    _, state = tx.update(tg, tx.init(tg))
    for got, w, g in zip(state["mu"], want, grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
        scale = min(1.0, ratio) * (1 - 0.9)
        np.testing.assert_allclose(got.numpy(), scale * g, rtol=1e-5)


def test_amp_loss_and_float32_state(jp_i, frames):
    """compute_dtype=bfloat16: the loss within AMP_RTOL of the JAX
    package's bfloat16 loss; float32 gradients land on float32 leaves."""
    x = frames[:, 0]

    def jax_amp(p, b):
        p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
        return JT.make_dmci_loss(LMBDA)(p16, b.astype(jnp.bfloat16), QP,
                                        jax.random.PRNGKey(0))[0]

    want = float(jax.jit(jax_amp)(jp_i, jnp.asarray(x)))
    params = from_jax(jp_i)
    tx = PT.make_optimizer(LR)
    state = tx.init(PT.tree_leaves(params))
    seen = []
    step = PT.make_train_step(
        PT.make_dmci_loss(LMBDA), tx, compute_dtype=torch.bfloat16,
        grad_transform=lambda g: seen.append(g) or g)
    params, state, metrics = step(params, state, torch.from_numpy(x), QP,
                                  None)
    _rel(metrics["loss"], want, AMP_RTOL)
    assert metrics["mse"].dtype == torch.bfloat16
    assert metrics["bpp"].dtype == torch.float32
    for t in PT.tree_leaves(seen[0]) + PT.tree_leaves(params) \
            + state["mu"] + state["nu"]:
        assert t.dtype == torch.float32


def test_freeze_subtree_matches_jax(jp_i):
    grads = jax.tree_util.tree_map(jnp.ones_like, jp_i)
    paths = ["hyper_enc/[1]", "dc_dw/b"]
    want = from_jax(JT.freeze_subtree(grads, paths))
    got = PT.freeze_subtree(from_jax(grads), paths)
    pairs = _pairs(got, want)
    for path, g, w in pairs:
        assert torch.equal(g, w), path
    assert 0 < sum(float(g.sum() == 0) for _, g, _ in pairs) < len(pairs)


def test_synthetic_batches_match():
    want = JDATA.SyntheticVideoDataset(3, 32, seed=5).batches(2, 3)
    got = PDATA.SyntheticVideoDataset(3, 32, seed=5).batches(2, 3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_vimeo_batches_match(tmp_path):
    """A septuplet tree of two sequences of 7 random 40x48 PNGs."""
    from PIL import Image
    rng = np.random.default_rng(6)
    names = ["00001/0001", "00002/0007"]
    for name in names:
        d = tmp_path / "sequences" / name
        d.mkdir(parents=True)
        for i in range(1, 8):
            Image.fromarray(rng.integers(0, 256, (40, 48, 3),
                                         dtype=np.uint8)).save(
                d / f"im{i}.png")
    (tmp_path / "sep_trainlist.txt").write_text("\n".join(names) + "\n")
    lst = str(tmp_path / "sep_trainlist.txt")
    want = JDATA.Vimeo90kSeptupletDataset(
        str(tmp_path), lst, 3, 32, rng=np.random.default_rng(8)).batches(3, 3)
    got = PDATA.Vimeo90kSeptupletDataset(
        str(tmp_path), lst, 3, 32, rng=np.random.default_rng(8)).batches(3, 3)
    for w, g in zip(want, got):
        assert g.shape == (3, 3, 32, 32, 3)
        np.testing.assert_array_equal(g, w)


def test_checkpoint_loads_in_jax(jp_i, frames, tmp_path):
    """save_params of trained port weights: the bytes the JAX package's
    save_params writes for the same tree, and JAX's load_params and
    forward give the port's forward."""
    params = from_jax(jp_i)
    tx = PT.make_optimizer(LR)
    state = tx.init(PT.tree_leaves(params))
    x = torch.from_numpy(frames[:, 0])
    params, _, _ = PT.make_train_step(PT.make_dmci_loss(LMBDA), tx)(
        params, state, x, QP, None)
    PCK.save_params(str(tmp_path / "p.msgpack"), params,
                    extra={"step": np.int64(1)})
    JCK.save_params(str(tmp_path / "j.msgpack"), to_jax(params),
                    extra={"step": np.int64(1)})
    assert (tmp_path / "p.msgpack").read_bytes() == \
        (tmp_path / "j.msgpack").read_bytes()
    loaded = JCK.load_checkpoint(str(tmp_path / "p.msgpack"))
    assert int(loaded["extra"]["step"]) == 1
    (_, want), _ = _J_DMCI_VG(loaded["params"], jnp.asarray(frames[:, 0]),
                              jax.random.PRNGKey(0), "ste")
    with torch.no_grad():
        got = PF.dmci_forward(params, x, QP)
    for k in ("mse", "bpp"):
        _rel(got[k], want[k])
    _close(got["x_hat"], want["x_hat"])


def test_train_video_cpu_saves_and_resumes(tmp_path):
    """Two steps of --model dmc on the CPU save dmc_latest.msgpack at step
    2; --resume continues at step 2 and saves step 3."""
    base = ["--device", "cpu", "--model", "dmc", "--batch_size", "1",
            "--crop", "32", "--save_dir", str(tmp_path), "--log_every", "1",
            "--warmup_steps", "0"]
    out = train_video.main(base + ["--steps", "2"])
    assert len(out["metrics"]) == 2
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
    path = str(tmp_path / "dmc_latest.msgpack")
    assert int(JCK.load_checkpoint(path)["extra"]["step"]) == 2
    again = train_video.main(base + ["--steps", "3", "--resume", path])
    assert len(again["metrics"]) == 1
    assert int(PCK.load_checkpoint(path)["extra"]["step"]) == 3


@pytest.mark.parametrize("argv,err", [
    ([], RuntimeError), (["--model", "tcm"], RuntimeError),
    (["--model", "dcvc"], RuntimeError),
    (["--device", "cpu", "--data_axis", "3", "--batch_size", "8"],
     ValueError)],
    ids=["cuda_without_cuda", "tcm", "dcvc", "data_axis"])
def test_train_video_refuses(argv, err, tmp_path):
    """The default --device cuda raises without CUDA (no silent CPU run),
    for DMC, TCM and DCVC (which train now); a data axis of 3 raises,
    as in the JAX package: one process does not split into it, nor does
    a batch of 8."""
    with pytest.raises(err):
        train_video.main(argv + ["--steps", "1", "--save_dir",
                                 str(tmp_path)])


def test_lmbda_ladder_matches(jp_i, frames, dmci_run):
    """lmbda_for_qp at qp 0, 21 and 63 (float32, as JAX computes it), and
    make_dmci_loss with the per-qp ladder: the JAX package's rd_loss at
    that lambda on its forward."""
    for qp in (0, 21, 63):
        want = JT.lmbda_for_qp(jnp.int32(qp), 64.0, 2048.0)
        assert float(PT.lmbda_for_qp(qp, 64.0, 2048.0)) == float(want)
    out = dmci_run["jax"][1]
    want = JT.rd_loss(out, JT.lmbda_for_qp(jnp.int32(QP), 64.0, 2048.0))
    with torch.no_grad():
        got, _ = PT.make_dmci_loss(64.0, lmbda_max=2048.0)(
            from_jax(jp_i), torch.from_numpy(frames[:, 0]), QP, None)
    _rel(got, want)
