"""The port's training campaign (`training/campaign.py`) and its synthetic
content (`training/syndata.py`) against the JAX package's, on the CPU.

Held exactly:
  * every syndata generator, bank, bank sample and `replace_refs`: the
    arrays bit-equal to the JAX package's for the same seeds;
  * the Prefetcher hands out its batches in order, and close() ends its
    worker even while the worker waits on a full queue;
  * the DMCI campaign at reduced widths (SMALL_KW, 6 steps, crop 64,
    batch 2, a 4-image bank of 96 px), both packages started from the
    JAX package's init (the port's init seam `campaign._dmci_params`
    patched to it): every step's batch and qp equal to the JAX
    campaign's;
  * the port killed at step 3 (stop_after) and resumed to 6 writes the
    uninterrupted run's file byte for byte (the JAX package's
    tests/test_training.py::test_campaign_kill_and_resume_reproduces, at
    reduced widths); a resume with another seed or total_steps raises.
Within stated tolerances: the DMCI campaign's parameters after 6 steps
within 12 lr of the JAX package's (no warmup at 6 steps, so every step
moves them: tests/test_torch_port_training.py's 2 lr a step for Adam's
normalized step, whose sign can flip where a gradient is near 0), 99 % of
them within lr / 100.  Smoke, as the JAX package's test_dmc_campaign_smoke:
the DMC campaign (full width, crop 64) on a frozen reduced DMCI rewrites
every sequence's reference and saves a finite train state at step 1; the
CLI trains 2 steps of the --tiny DMCI with --device cpu and refuses to
run without CUDA otherwise.
"""

import os

import numpy as np
import pytest
import torch

import jax
from opendcvc_tpu.eval.rd_evidence import TINY_KW as JAX_TINY_KW
from opendcvc_tpu.models import common as JC
from opendcvc_tpu.models.dmci import dmci_init as jax_dmci_init
from opendcvc_tpu.training import campaign as JCAMP
from opendcvc_tpu.training import syndata as JS
from opendcvc_tpu.training import train as JT
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.training import campaign as PCAMP
from opendcvc_tpu_torch.training import syndata as PS
from opendcvc_tpu_torch.utils import checkpoint as PCK
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

SMALL_KW = {"N": 32, "z_channel": 32, "enc_dec_ch": 32}
CAMPAIGN = dict(total_steps=6, seed=3, bank_images=4, bank_size=96,
                stages=((1.0, 64, 2),), save_every=3, log_every=100,
                eval_every=0, model_kw=SMALL_KW)
LR = 1e-4

GENERATORS = [
    ("natural_images", lambda m: m.natural_images(3, 48, seed=5)),
    ("natural_images_wide",
     lambda m: m.natural_images(2, 40, seed=6, width=72)),
    ("natural_pairs", lambda m: m.natural_pairs(3, 40, seed=7)),
    ("natural_seqs", lambda m: m.natural_seqs(2, 40, t=4, seed=8)),
    ("fractal_fields", lambda m: [m._fractal_fields(
        np.random.default_rng(9), 3, 24, 40, 0.8, 2.0)]),
]


def _flat(out):
    return [np.asarray(a) for item in out for a in
            (item if isinstance(item, tuple) else (item,))]


@pytest.mark.parametrize("name,make", GENERATORS,
                         ids=[n for n, _ in GENERATORS])
def test_syndata_generators_bit_equal(name, make):
    want, got = _flat(make(JS)), _flat(make(PS))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), name


BANKS = [
    ("image", lambda m: m.ImageBank(n_images=3, size=64, seed=1),
     [(4, 32, {}), (2, 64, {})]),
    ("pair", lambda m: m.PairBank(n_pairs=3, size=48, seed=2),
     [(4, 32, {})]),
    ("seq", lambda m: m.SeqBank(n_seqs=3, size=48, t=3, seed=3),
     [(4, 32, {}), (3, 40, {"t": 2})]),
]


@pytest.mark.parametrize("name,make,draws", BANKS,
                         ids=[n for n, _, _ in BANKS])
def test_bank_samples_bit_equal(name, make, draws):
    jb, pb = make(JS), make(PS)
    assert np.array_equal(pb.bank, jb.bank)
    for batch, crop, kw in draws:
        want = jb.sample(np.random.default_rng(11), batch, crop, **kw)
        got = pb.sample(np.random.default_rng(11), batch, crop, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_replace_refs_bit_equal():
    jb = JS.SeqBank(n_seqs=5, size=40, t=3, seed=4)
    pb = PS.SeqBank(n_seqs=5, size=40, t=3, seed=4)
    before = pb.bank.copy()

    def fn(x):
        return np.sqrt(x) * 1.1 - 0.05

    jb.replace_refs(fn, batch=2)
    pb.replace_refs(fn, batch=2)
    assert np.array_equal(pb.bank, jb.bank)
    assert np.array_equal(pb.bank[:, 1:], before[:, 1:])
    assert not np.array_equal(pb.bank[:, 0], before[:, 0])


def test_prefetcher_order_and_close():
    """Batches in the order they were made; close() while the worker
    blocks on a full queue ends it."""
    made = iter(range(1000))
    pf = PS.Prefetcher(lambda: next(made), depth=2)
    assert [pf.next() for _ in range(5)] == [0, 1, 2, 3, 4]
    while not pf.q.full():
        pass
    pf.close()
    assert not pf.t.is_alive()

    def boom():
        raise RuntimeError("no batch")

    pf = PS.Prefetcher(boom)
    with pytest.raises(RuntimeError, match="no batch"):
        pf.next()
    pf.close()


def _jax_small_init(seed, kw):
    return JC.run_init(lambda k: jax_dmci_init(k, **kw),
                       jax.random.PRNGKey(seed))


def _recording(orig, seen):
    """A make_train_step whose steps record (batch, qp)."""
    def make(loss_fn, tx, **kw):
        step = orig(loss_fn, tx, **kw)

        def wrapped(params, opt_state, batch, qp, rng):
            b = batch.numpy() if isinstance(batch, torch.Tensor) \
                else np.asarray(batch)
            seen.append((b, int(qp)))
            return step(params, opt_state, batch, qp, rng)
        return wrapped
    return make


@pytest.fixture
def jax_init_seam(monkeypatch):
    """Start the port's DMCI campaign from the JAX package's init."""
    monkeypatch.setattr(PCAMP, "_dmci_params", lambda seed, kw: from_jax(
        _jax_small_init(seed, kw)))


def test_dmci_campaign_matches_jax(tmp_path, monkeypatch, jax_init_seam):
    jseen, pseen = [], []
    monkeypatch.setattr(JT, "make_train_step",
                        _recording(JT.make_train_step, jseen))
    monkeypatch.setattr(PCAMP, "make_train_step",
                        _recording(PCAMP.make_train_step, pseen))
    JCAMP.train_dmci_campaign(str(tmp_path / "j.msgpack"), **CAMPAIGN)
    PCAMP.train_dmci_campaign(str(tmp_path / "p.msgpack"), device="cpu",
                              **CAMPAIGN)
    assert len(pseen) == len(jseen) == 6
    for (pb, pq), (jb, jq) in zip(pseen, jseen):
        assert pq == jq and np.array_equal(pb, jb)
    want = JCK.load_checkpoint(str(tmp_path / "j.msgpack"))
    got = PCK.load_checkpoint(str(tmp_path / "p.msgpack"))
    assert int(got["step"]) == int(want["step"]) == 6
    flat_w = jax.tree_util.tree_leaves_with_path(want["params"])
    flat_g = dict((jax.tree_util.keystr(p), v) for p, v in
                  jax.tree_util.tree_leaves_with_path(got["params"]))
    diffs = []
    for path, w in flat_w:
        d = np.abs(flat_g[jax.tree_util.keystr(path)] - np.asarray(w))
        assert float(d.max()) <= 12 * LR, jax.tree_util.keystr(path)
        diffs.append(d.ravel())
    d = np.concatenate(diffs)
    print(f"params: max diff {d.max():.3g}, share within lr/100 "
          f"{(d <= LR / 100).mean():.5f}")
    assert (d <= LR / 100).mean() >= 0.99


def test_dmci_campaign_kill_and_resume_exact(tmp_path, jax_init_seam):
    a, b = str(tmp_path / "a.msgpack"), str(tmp_path / "b.msgpack")
    PCAMP.train_dmci_campaign(a, device="cpu", **CAMPAIGN)
    PCAMP.train_dmci_campaign(b, stop_after=3, device="cpu", **CAMPAIGN)
    assert int(PCK.load_checkpoint(b)["step"]) == 3
    PCAMP.train_dmci_campaign(b, resume=True, device="cpu", **CAMPAIGN)
    assert open(a, "rb").read() == open(b, "rb").read()
    for key, value in (("seed", 4), ("total_steps", 7)):
        with pytest.raises(ValueError, match=key):
            PCAMP.train_dmci_campaign(b, resume=True, device="cpu",
                                      **dict(CAMPAIGN, **{key: value}))


def test_dmc_campaign_smoke(tmp_path, monkeypatch):
    """A full-size DMC campaign step on references rewritten by a frozen
    reduced DMCI (the port's own init), as the JAX package's
    test_dmc_campaign_smoke."""
    from opendcvc_tpu_torch.models.dmci import dmci_init
    ipath = str(tmp_path / "i.msgpack")
    PCK.save_params(ipath, dmci_init(torch.Generator().manual_seed(0),
                                     **SMALL_KW))
    banks = []
    orig = PCAMP._recon_refs

    def spy(bank, groups, ckpt, device):
        before = bank.bank.copy()
        orig(bank, groups, ckpt, device)
        banks.append((before, bank.bank.copy()))

    monkeypatch.setattr(PCAMP, "_recon_refs", spy)
    out = str(tmp_path / "dmc.msgpack")
    PCAMP.train_dmc_campaign(out, dmci_ckpt=ipath, total_steps=2,
                             stop_after=1, bank_seqs=4, bank_size=96,
                             seq_t=2, stages=((1.0, 64, 1, 1),),
                             save_every=1, log_every=1, eval_every=0,
                             device="cpu")
    (before, after), = banks
    assert np.array_equal(before[:, 1:], after[:, 1:])
    assert all(not np.array_equal(before[i, 0], after[i, 0])
               for i in range(4))
    payload = PCK.load_checkpoint(out)
    assert int(payload["step"]) == 1
    assert all(np.isfinite(np.asarray(v)).all() for v in
               jax.tree_util.tree_leaves(payload["params"]))
    assert "opt_state" in JCK.load_checkpoint(out)


def test_campaign_cli(tmp_path):
    out = str(tmp_path / "tiny.msgpack")
    PCAMP.main(["--out", out, "--steps", "2", "--tiny", "--bank_images",
                "2", "--bank_size", "256", "--device", "cpu"])
    payload = PCK.load_checkpoint(out)
    assert int(payload["step"]) == 2
    assert {k: int(v) for k, v in
            payload["extra"]["model_kwargs"].items()} == JAX_TINY_KW
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PCAMP.main(["--out", out, "--steps", "2"])
    assert os.path.exists(out)
