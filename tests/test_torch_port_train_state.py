"""The port's full training state (`utils/checkpoint.py::save_train_state`
/ `load_train_state`) and reduce-on-plateau (`training/train.py`) against
the JAX package's, on the CPU.

Trees: the JAX package's DMCI at reduced widths (SMALL_KW, PRNGKey(0))
and its DCVC (PRNGKey(1), whose masked convolutions carry "mask" leaves),
with the optimizer state of a run two steps in (seeded Adam moments, a
plateau state mid-run), saved by the JAX package's `save_train_state`
with and without a plateau state.  Held exactly:
  * the port loads the JAX package's file: the parameters, Adam's count
    and moments of every trainable leaf, the plateau state, the step and
    the extra; a DCVC mask's moments are dropped (the port never trains
    a mask, the JAX package does);
  * the port's file of that state is the JAX package's bytes (DCVC: the
    JAX state with the masks' moments zeroed), and the JAX package's
    `load_train_state` reads it;
  * a params-only file, a plateau state against an optimizer without one
    (and the reverse) and a mismatched extra raise ValueError;
  * reduce-on-plateau against optax.contrib.reduce_on_plateau (optax
    0.2.6): the JAX test's sequence (tests/test_training.py) and seeded
    random sequences with cooldown, accumulation_size > 1, min_scale,
    rtol and atol: every state field equal, float32 bit for bit, and
    every update (Adam's, times the plateau's scale) within ADAM_RTOL
    relative (the port's Adam rounds its moments' update differently,
    tests/test_torch_port_training.py::test_clip_matches_optax).
Within stated tolerances: make_train_step(plateau=True) for three steps
at a reduced DMCI (32x32 frames, batch 2, qp 21, cosine over 10 steps
after 1 warmup step, a plateau that halves the scale twice): the
plateau's integer fields and scale exact, its running mean and best
value within FWD_RTOL relative (the loss's float agreement), each
parameter within 6 lr of the JAX package's (tests/test_torch_port_
training.py's bound and reason).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from opendcvc_tpu.models import common as JC
from opendcvc_tpu.models.dcvc import dcvc_init as jax_dcvc_init
from opendcvc_tpu.models.dmci import dmci_init as jax_dmci_init
from opendcvc_tpu.training import train as JT
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.training import train as PT
from opendcvc_tpu_torch.utils import checkpoint as PCK
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

SMALL_KW = {"N": 32, "z_channel": 32, "enc_dec_ch": 32}
PLATEAU = dict(factor=0.5, patience=2, cooldown=1, accumulation_size=2,
               min_scale=0.2)
EXTRA = {"model_kwargs": SMALL_KW, "seed": 3, "total_steps": 12,
         "lmbda": [32.0, 4096.0]}
LR, FWD_RTOL, HW, QP = 1e-4, 1e-4, 32, 21
ADAM_RTOL = 1e-6
PLATEAU_KEYS = ("avg_value", "best_value", "cooldown_count", "count",
                "plateau_count", "scale")


@pytest.fixture(scope="module")
def trees():
    return {"dmci": JC.run_init(lambda k: jax_dmci_init(k, **SMALL_KW),
                                jax.random.PRNGKey(0)),
            "dcvc": JC.run_init(jax_dcvc_init, jax.random.PRNGKey(1))}


def _stepped(jp, plateau, seed=5):
    """(optimizer, params, optax state) of a run two steps in: seeded Adam
    moments (nu positive), both counts 2 and, with plateau, a plateau
    state mid-run."""
    tx = JT.make_optimizer(LR, "cosine", 10, 1, plateau=plateau)
    rng = np.random.default_rng(seed)

    def draw(a, positive=False):
        v = rng.standard_normal(a.shape).astype(np.float32)
        return jnp.asarray(np.abs(v) if positive else v)

    state = tx.init(jp)
    two = jnp.asarray(2, jnp.int32)
    adam = state[1][0]._replace(
        count=two, mu=jax.tree_util.tree_map(draw, jp),
        nu=jax.tree_util.tree_map(lambda a: draw(a, True), jp))
    parts = (state[0], (adam, state[1][1]._replace(count=two)))
    if plateau:
        parts += (state[2]._replace(
            avg_value=jnp.float32(1.25), best_value=jnp.float32(1.5),
            plateau_count=jnp.int32(1), cooldown_count=jnp.int32(1),
            count=jnp.int32(1), scale=jnp.float32(0.5)),)
    return tx, jp, parts


_STEPPED = {}


def _stepped_once(trees, model, plateau):
    """_stepped of a tree and plateau, computed once per module."""
    key = (model, plateau is None)
    if key not in _STEPPED:
        _STEPPED[key] = _stepped(trees[model], plateau)
    return _STEPPED[key]


def _zero_masks(state):
    """The JAX state with every "mask" leaf's Adam moments zeroed."""
    def zero(path, x):
        return jnp.zeros_like(x) if "mask" in jax.tree_util.keystr(path) \
            else x
    adam = state[1][0]
    adam = adam._replace(mu=jax.tree_util.tree_map_with_path(zero, adam.mu),
                         nu=jax.tree_util.tree_map_with_path(zero, adam.nu))
    return (state[0], (adam, state[1][1])) + tuple(state[2:])


def _by_path(tree):
    return dict(zip(PT._paths(tree), PT.tree_leaves(tree)))


def _port_tx(plateau):
    return PT.make_optimizer(LR, "cosine", 10, 1, plateau=plateau)


def _load_port(path, jp, plateau):
    like = from_jax(jp)
    return PCK.load_train_state(
        path, like, _port_tx(plateau).init(PT.trainable_leaves(like)))


CASES = [("dmci", None), ("dmci", PLATEAU), ("dcvc", None),
         ("dcvc", PLATEAU)]
IDS = ["dmci", "dmci_plateau", "dcvc", "dcvc_plateau"]


@pytest.mark.parametrize("model,plateau", CASES, ids=IDS)
def test_jax_train_state_loads_in_port(trees, model, plateau, tmp_path):
    _, jp, state = _stepped_once(trees, model, plateau)
    path = str(tmp_path / "j.msgpack")
    JCK.save_train_state(path, jp, state, 2, extra=EXTRA)
    params, opt, step, extra = _load_port(path, trees[model], plateau)
    assert step == 2 and opt["count"] == 2
    PCK.check_train_extra(path, extra, EXTRA)
    want = _by_path(from_jax(jp))
    got = _by_path(params)
    assert set(got) == set(want)
    for path, t in got.items():
        assert torch.equal(t, want[path]), path
    # the run's key order, so the optimizer's leaf order
    paths = PT._paths(params)
    assert paths == PT._paths(from_jax(trees[model]))
    keep = PT._trainable(params)
    assert (not all(keep)) == (model == "dcvc")
    for k in ("mu", "nu"):
        moments = _by_path(from_jax(getattr(state[1][0], k)))
        ref = [moments[p] for p, kept in zip(paths, keep) if kept]
        assert len(opt[k]) == len(ref)
        for t, w in zip(opt[k], ref):
            assert torch.equal(t, w)
    if plateau:
        for k in PLATEAU_KEYS:
            assert np.array_equal(opt["plateau"][k].numpy(),
                                  np.asarray(getattr(state[2], k))), k
    else:
        assert "plateau" not in opt


@pytest.mark.parametrize("model,plateau", CASES, ids=IDS)
def test_port_train_state_is_jax_bytes(trees, model, plateau, tmp_path):
    """The port's file of a loaded state equals the JAX package's file of
    that state (mask moments zeroed), and loads in the JAX package."""
    tx, jp, state = _stepped_once(trees, model, plateau)
    JCK.save_train_state(str(tmp_path / "j.msgpack"), jp, state, 2,
                         extra=EXTRA)
    params, opt, step, extra = _load_port(str(tmp_path / "j.msgpack"),
                                          trees[model], plateau)
    PCK.save_train_state(str(tmp_path / "p.msgpack"), params, opt, step,
                         extra=EXTRA)
    JCK.save_train_state(str(tmp_path / "z.msgpack"), jp,
                         _zero_masks(state), 2, extra=EXTRA)
    assert (tmp_path / "p.msgpack").read_bytes() == \
        (tmp_path / "z.msgpack").read_bytes()
    jparams, jstate, jstep, jextra = JCK.load_train_state(
        str(tmp_path / "p.msgpack"), tx.init(trees[model]))
    assert jstep == 2 and int(jextra["seed"]) == 3
    for a, b in zip(jax.tree_util.tree_leaves(jstate),
                    jax.tree_util.tree_leaves(_zero_masks(state))):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_train_state_refusals(trees, tmp_path):
    jp = trees["dmci"]
    only = str(tmp_path / "params.msgpack")
    JCK.save_params(only, jp)
    with pytest.raises(ValueError, match="params-only"):
        _load_port(only, jp, None)
    for saved, wanted in ((PLATEAU, None), (None, PLATEAU)):
        _, p, state = _stepped_once(trees, "dmci", saved)
        path = str(tmp_path / f"{saved is None}.msgpack")
        JCK.save_train_state(path, p, state, 2, extra=EXTRA)
        with pytest.raises(ValueError, match="optimizer state"):
            _load_port(path, jp, wanted)
    _, _, _, extra = _load_port(path, jp, None)
    for key, value in (("seed", 4), ("total_steps", 13),
                       ("lmbda", [32.0, 2048.0]),
                       ("model_kwargs", {"N": 64, "z_channel": 32,
                                         "enc_dec_ch": 32})):
        with pytest.raises(ValueError, match=key):
            PCK.check_train_extra(path, extra, dict(EXTRA, **{key: value}))
    with pytest.raises(ValueError):
        PCK.check_train_extra(path, None, EXTRA)


def _plateau_runs(config, values):
    """(port, optax) (updates, state) after each value, on one leaf of
    ones with ones for gradients at lr 1 (the JAX test's setting)."""
    jtx = JT.make_optimizer(1.0, "constant", plateau=config)
    ptx = PT.make_optimizer(1.0, "constant", plateau=config)
    jp = {"w": jnp.ones((4,))}
    jstate = jtx.init(jp)
    leaves = [torch.ones(4)]
    pstate = ptx.init(leaves)
    update = jax.jit(lambda s, v: jtx.update(jp, s, jp, value=v))
    out = []
    for v in values:
        jup, jstate = update(jstate, jnp.float32(v))
        pup, pstate = ptx.update([torch.ones(4)], pstate,
                                 value=torch.tensor(v, dtype=torch.float32))
        out.append(((pup[0], pstate["plateau"]), (jup["w"], jstate[2])))
    return out


def _same_plateau(port, ref):
    """The plateau state bit for bit; the update (Adam's times the scale)
    within ADAM_RTOL."""
    (pup, pst), (jup, jst) = port, ref
    np.testing.assert_allclose(pup.numpy(), np.asarray(jup), rtol=ADAM_RTOL,
                               atol=0)
    for k in PLATEAU_KEYS:
        got, want = pst[k].numpy(), np.asarray(getattr(jst, k))
        assert got.dtype == want.dtype and np.array_equal(got, want), k


def test_plateau_jax_test_sequence():
    """tests/test_training.py::test_plateau_optimizer_reduces_lr: a loss
    stuck at 1.0 halves the scale every `patience` steps."""
    runs = _plateau_runs(dict(factor=0.5, patience=2, cooldown=0,
                              accumulation_size=1), [1.0] * 8)
    for port, ref in runs:
        _same_plateau(port, ref)
    scales = [float(p[0].abs()[0]) for p, _ in runs]
    assert scales[-1] < scales[0] * 0.75, scales


RANDOM_CONFIGS = [
    dict(factor=0.5, patience=2, cooldown=2, accumulation_size=3,
         min_scale=0.3),
    dict(factor=0.7, patience=1, cooldown=0, accumulation_size=1,
         rtol=1e-3, atol=0.01),
    dict(factor=0.1, patience=3, cooldown=1, accumulation_size=2,
         rtol=0.0, atol=0.05, min_scale=0.01),
]


@pytest.mark.parametrize("config", RANDOM_CONFIGS,
                         ids=["cooldown_acc3_min", "rtol_atol",
                              "atol_only"])
def test_plateau_random_sequence(config):
    """60 seeded losses: a falling stretch, a plateau with noise, a
    spike, a second plateau."""
    rng = np.random.default_rng(7)
    values = np.concatenate([
        np.linspace(3.0, 1.0, 15), 1.0 + 0.02 * rng.standard_normal(20),
        [5.0, 4.0], 0.9 + 0.05 * rng.standard_normal(23)]).astype(np.float32)
    runs = _plateau_runs(config, [float(v) for v in values])
    for port, ref in runs:
        _same_plateau(port, ref)
    assert float(runs[-1][0][1]["scale"]) < 1.0


def test_plateau_refuses_bad_settings():
    for bad in (dict(factor=1.0), dict(rtol=-1.0), dict(rtol=0.0, atol=0.0),
                dict(rtol=2.0)):
        with pytest.raises(ValueError):
            PT.make_optimizer(LR, plateau=bad)
    tx = PT.make_optimizer(LR, plateau={})
    leaves = [torch.ones(3)]
    with pytest.raises(ValueError, match="monitored loss"):
        tx.update([torch.ones(3)], tx.init(leaves))


STEP_PLATEAU = dict(factor=0.5, patience=1, rtol=0.5)


def test_plateau_train_step_matches_jax(trees):
    """Three steps of make_train_step(plateau=True) on the DMCI loss: the
    loss falls by less than half a step, so after the first step each step
    halves the scale."""
    jp = trees["dmci"]
    x = np.random.default_rng(0).random((2, HW, HW, 3), np.float32)
    loss_fn = JT.make_dmci_loss(256.0)
    jtx = JT.make_optimizer(LR, "cosine", 10, 1, 1.0, plateau=STEP_PLATEAU)
    jstep = JT.make_train_step(loss_fn, jtx, donate=False, plateau=True)
    jstate, jparams = jtx.init(jp), jp
    for _ in range(3):
        jparams, jstate, _ = jstep(jparams, jstate, jnp.asarray(x),
                                   jnp.int32(QP), jax.random.PRNGKey(0))
    params = from_jax(jp)
    tx = PT.make_optimizer(LR, "cosine", 10, 1, 1.0, plateau=STEP_PLATEAU)
    step = PT.make_train_step(PT.make_dmci_loss(256.0), tx, plateau=True)
    state = tx.init(PT.tree_leaves(params))
    for _ in range(3):
        params, state, _ = step(params, state, torch.from_numpy(x), QP, None)
    got, want = state["plateau"], jstate[2]
    assert float(got["scale"]) == float(want.scale) == 0.25
    for k in ("cooldown_count", "count", "plateau_count"):
        assert int(got[k]) == int(getattr(want, k)), k
    for k in ("avg_value", "best_value"):
        w = float(getattr(want, k))
        assert abs(float(got[k]) - w) <= FWD_RTOL * abs(w), k
    want = _by_path(from_jax(jparams))
    for path, t in _by_path(params).items():
        assert float((t.detach() - want[path]).abs().max()) <= 6 * LR, path
