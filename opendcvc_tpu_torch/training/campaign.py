"""DCVC-RT's RD training campaign on one device: the full-size DMCI on
synthetic content with natural statistics, then the DMC chain on top.

    python -m opendcvc_tpu_torch.training.campaign --out ckpt/dmci.msgpack \
        --steps 200000 [--device cpu]
    # kill any time; resume with the same command + --resume

Counterpart of the JAX package's `training/campaign.py`, with its options:
  * content: `training/syndata.py`'s ImageBank (DMCI) or SeqBank (DMC),
    generated once; a Prefetcher thread cuts the crop/flip batches;
  * each step's batch and qp come from np.random.default_rng((seed + 1) *
    1_000_003 + step), so the data stream is the JAX package's bit for bit
    and a resumed run draws what the uninterrupted one drew;
  * the qp-matched lambda ladder (`lmbda_for_qp`), the cosine schedule
    after min(500, total_steps // 20) warmup steps, straight-through
    quantization;
  * staged crops (DEFAULT_STAGES, DMC_STAGES): a stage ends at
    int(frac * total_steps) summed over the stages so far, the last at
    total_steps;
  * the full training state (`utils/checkpoint.py::save_train_state`, the
    JAX package's layout) saved every save_every steps and at the end;
    stop_after ends the run after that step, as a kill would; resume
    restores the parameters, Adam's moments and the step, and raises
    unless the saved `extra` matches this run's model_kwargs, seed,
    total_steps and lmbda (the JAX campaign does not check it).
The DMC campaign can first rewrite each sequence's frame 0 through a
frozen DMCI checkpoint's straight-through reconstruction at its group's
qp anchor (REF_QP_ANCHORS), in batches of 8, and then samples each step's
qp near the batch's anchor.

Each step's noise generator is a torch.Generator seeded from (seed + 2,
step), the counterpart of the JAX package's fold_in(PRNGKey(seed + 2),
step); the straight-through quantizers draw no noise, so neither is read.
The initial weights are the port's own init, drawn by torch.Generator
from the seed (not the JAX package's).  Batches reach the device through
`models/common.py::upload` (pinned, no wait).  The campaign runs on
`device` (default cuda; without CUDA that raises unless device="cpu") and
logs each stage's median ms a step (CUDA events on the card, the host's
clock on the CPU) when the stage ends.
"""

import argparse
import json
import time

import numpy as np
import torch

from ..models import common as C
from ..models.dmc import dmc_init
from ..models.dmci import dmci_init
from ..train_video import _elapsed_ms, _mark
from ..utils import checkpoint as ckpt
from ..utils.params import from_jax, to_device
from .forward import dmc_forward_one_frame, dmci_forward
from .syndata import (ImageBank, Prefetcher, SeqBank, natural_images,
                      natural_seqs)
from .train import (make_dmc_loss, make_dmci_loss, make_optimizer,
                    make_train_step, trainable_leaves)

DEFAULT_STAGES = (
    # (fraction of total steps, crop, batch)
    (0.70, 128, 8),
    (0.20, 192, 4),
    (0.10, 256, 2),
)

#: DMC stage plan: (fraction of steps, crop, batch, P-frames).  Most steps
#: code one P-frame; later stages cascade two, so the feature chain trains
#: end to end.
DMC_STAGES = (
    (0.55, 128, 8, 1),
    (0.30, 128, 4, 2),
    (0.15, 192, 2, 2),
)

#: the qp anchors of the frozen DMCI's reference reconstructions; a step's
#: qp stays near its batch's anchor, so reference quality and target rate
#: correlate as in a real GOP
REF_QP_ANCHORS = (8, 24, 40, 56)

EVAL_QPS = (0, 16, 32, 48)


def _dmci_params(seed, model_kw):
    """The port's DMCI init drawn from `seed` (CPU tensors)."""
    return dmci_init(torch.Generator().manual_seed(seed), **model_kw)


def _dmc_params(seed):
    """The port's DMC init drawn from `seed` (CPU tensors)."""
    return dmc_init(torch.Generator().manual_seed(seed))


def _data_rng(seed, step):
    return np.random.default_rng((seed + 1) * 1_000_003 + step)


def _noise_rng(seed, step, device):
    return torch.Generator(device=device).manual_seed(
        (seed + 2) * 1_000_003 + step)


def _bounds(stages, total_steps):
    """[(end step, stage spec)]: int(frac * total) summed, the last end
    forced to total_steps."""
    out, acc = [], 0
    for frac, *spec in stages:
        acc += int(frac * total_steps)
        out.append((acc, tuple(spec)))
    out[-1] = (total_steps, out[-1][1])
    return out


def _probe_rows(qps, run):
    """[{qp, psnr, bpp}] of run(qp) -> [(mse, bpp)] over the probe set."""
    rows = []
    for qp in qps:
        mses, bpps = zip(*run(qp))
        mse = float(np.mean(mses))
        rows.append({"qp": int(qp),
                     "psnr": round(-10 * np.log10(max(mse, 1e-10)), 3),
                     "bpp": round(float(np.mean(bpps)), 4)})
    return rows


def _eval_probe(params, eval_imgs, qps, device):
    """RD probe of a DMCI on held-out images from the forward's analytic
    bits (no coder): PSNR and bpp at each qp."""
    def run(qp):
        with torch.no_grad():
            outs = [dmci_forward(params, C.upload(img, device), qp)
                    for img in eval_imgs]
        return [(float(o["mse"]), float(o["bpp"])) for o in outs]
    return _probe_rows(qps, run)


def _eval_probe_dmc(params, eval_seqs, qps, device):
    """RD probe of a DMC on held-out pairs (frame 1 from frame 0)."""
    def run(qp):
        with torch.no_grad():
            outs = [dmc_forward_one_frame(
                params, C.upload(seq[1:2], device),
                C.upload(seq[0:1], device), None, qp) for seq in eval_seqs]
        return [(float(o["mse"]), float(o["bpp"])) for o in outs]
    return _probe_rows(qps, run)


def _campaign(out_ckpt, params, loss_fn, bounds, make_gen, describe,
              probe, extra, total_steps, seed, base_lr, resume, save_every,
              log_every, eval_every, log_path, stop_after, amp, device):
    """The step loop both campaigns share.  make_gen(first step, stage
    spec) -> a callable returning (batch, qp) for one step after another;
    describe(spec) names a stage in the log; probe(params) -> eval rows."""
    tx = make_optimizer(base_lr=base_lr, schedule="cosine",
                        total_steps=total_steps,
                        warmup_steps=min(500, total_steps // 20))
    step_fn = make_train_step(
        loss_fn, tx, compute_dtype=torch.bfloat16 if amp else None)
    params = to_device(params, device)
    opt_state = tx.init(trainable_leaves(params))
    i = 0
    if resume:
        params, opt_state, i, saved = ckpt.load_train_state(
            out_ckpt, params, opt_state)
        ckpt.check_train_extra(out_ckpt, saved, extra)
        print(f"resumed from {out_ckpt} at step {i}", flush=True)

    logf = open(log_path, "a") if log_path else None

    def log(msg):
        print(msg, flush=True)
        if logf:
            logf.write(msg + "\n")
            logf.flush()

    ema = None
    try:
        while i < total_steps:
            stage_end, spec = next((e, s) for e, s in bounds if i < e)
            pf = Prefetcher(make_gen(i, spec), depth=4)
            t0, n0, marks = time.perf_counter(), i, []
            try:
                while i < stage_end:
                    data, qp = pf.next()
                    start = _mark(device)
                    params, opt_state, metrics = step_fn(
                        params, opt_state, C.upload(data, device), qp,
                        _noise_rng(seed, i, device))
                    marks.append((start, _mark(device)))
                    i += 1
                    if i % log_every == 0:
                        loss = float(metrics["loss"])
                        ema = loss if ema is None else 0.9 * ema + 0.1 * loss
                        sps = (i - n0) / (time.perf_counter() - t0)
                        log(f"step {i}/{total_steps} {describe(spec)} "
                            f"loss={loss:.4f} ema={ema:.4f} "
                            f"bpp={float(metrics['bpp']):.4f} "
                            f"mse={float(metrics['mse']):.5f} qp={qp} "
                            f"{sps:.1f} steps/s")
                    if i % save_every == 0 or i == total_steps:
                        ckpt.save_train_state(out_ckpt, params, opt_state,
                                              i, extra=extra)
                    if stop_after is not None and i >= stop_after:
                        return out_ckpt
                    if eval_every and i % eval_every == 0:
                        log(f"eval @ {i}: {json.dumps(probe(params))}")
            finally:
                pf.close()
                if marks:
                    if device.type == "cuda":
                        marks[-1][1].synchronize()
                    ms = [_elapsed_ms(a, b) for a, b in marks]
                    log(f"stage {describe(spec)}: steps {n0 + 1}-{i}, "
                        f"{float(np.median(ms)):.1f} ms a step (median; "
                        f"each: " + " ".join(f"{t:.1f}" for t in ms) + ")")
    finally:
        if logf:
            logf.close()
    return out_ckpt


def train_dmci_campaign(out_ckpt, total_steps=200_000, seed=0,
                        base_lr=1e-4, lmbda_min=32.0, lmbda_max=4096.0,
                        bank_images=512, bank_size=320,
                        stages=DEFAULT_STAGES, resume=False,
                        save_every=2000, log_every=500, eval_every=10000,
                        log_path=None, model_kw=None, stop_after=None,
                        amp=False, device="cuda"):
    """Train a DMCI (model_kw: its widths, {} the full size) on an
    ImageBank; returns out_ckpt, the train state's path."""
    device = C.resolve_device(device)
    kw = model_kw or {}
    t_bank = time.perf_counter()
    bank = ImageBank(n_images=bank_images, size=bank_size, seed=seed)
    eval_imgs = natural_images(4, 256, seed=seed + 77777)
    print(f"bank ready: {bank_images}x{bank_size}px in "
          f"{time.perf_counter() - t_bank:.0f}s", flush=True)

    def make_gen(start, spec):
        crop, batch = spec
        counter = [start]

        def gen():
            r = _data_rng(seed, counter[0])
            counter[0] += 1
            return bank.sample(r, batch, crop), int(r.integers(0, 64))
        return gen

    return _campaign(
        out_ckpt, _dmci_params(seed, kw),
        make_dmci_loss(lmbda_min, quant_mode="ste", lmbda_max=lmbda_max),
        _bounds(stages, total_steps), make_gen,
        lambda s: f"crop={s[0]} batch={s[1]}",
        lambda p: _eval_probe(p, eval_imgs, EVAL_QPS, device),
        {"model_kwargs": kw, "seed": seed, "total_steps": total_steps,
         "lmbda": [lmbda_min, lmbda_max]},
        total_steps, seed, base_lr, resume, save_every, log_every,
        eval_every, log_path, stop_after, amp, device)


def _recon_refs(bank, groups, dmci_ckpt, device):
    """Rewrite each group's frame 0 through the frozen DMCI's
    straight-through x_hat at the group's anchor qp, 8 at a time."""
    ipar = from_jax(ckpt.load_params(dmci_ckpt), device)
    for a, qp in enumerate(REF_QP_ANCHORS):
        idxs = groups[a]
        for lo in range(0, len(idxs), 8):
            sel = idxs[lo:lo + 8]
            refs = bank.bank[sel, 0].astype(np.float32) / 255.0
            with torch.no_grad():
                rec = dmci_forward(ipar, C.upload(refs, device), qp)["x_hat"]
            bank.bank[sel, 0] = np.round(np.clip(
                rec.float().cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def train_dmc_campaign(out_ckpt, dmci_ckpt=None, total_steps=100_000,
                       seed=0, base_lr=1e-4, lmbda_min=32.0,
                       lmbda_max=4096.0, bank_seqs=384, bank_size=256,
                       seq_t=3, stages=DMC_STAGES, resume=False,
                       save_every=2000, log_every=500, eval_every=10000,
                       log_path=None, stop_after=None, amp=False,
                       device="cuda"):
    """Train a full-size DMC on a SeqBank of synthetic motion sequences;
    returns out_ckpt.  With dmci_ckpt, every sequence's frame 0 is first
    rewritten through that frozen DMCI at one of REF_QP_ANCHORS, and each
    step's qp is drawn near its batch's anchor."""
    device = C.resolve_device(device)
    t_bank = time.perf_counter()
    bank = SeqBank(n_seqs=bank_seqs, size=bank_size, t=seq_t, seed=seed)
    eval_seqs = natural_seqs(4, 256, t=2, seed=seed + 77777)
    anchor_of = np.random.default_rng(seed + 31337).integers(
        0, len(REF_QP_ANCHORS), bank_seqs)
    groups = [np.nonzero(anchor_of == a)[0]
              for a in range(len(REF_QP_ANCHORS))]
    if dmci_ckpt:
        _recon_refs(bank, groups, dmci_ckpt, device)
        print(f"refs reconned through frozen DMCI at anchors "
              f"{REF_QP_ANCHORS}", flush=True)
    print(f"seq bank ready: {bank_seqs}x{bank_size}px t={seq_t} in "
          f"{time.perf_counter() - t_bank:.0f}s", flush=True)

    def make_gen(start, spec):
        crop, batch, n_p = spec
        counter = [start]

        def gen():
            r = _data_rng(seed, counter[0])
            counter[0] += 1
            a = int(r.integers(0, len(REF_QP_ANCHORS)))
            if dmci_ckpt and len(groups[a]):
                sel = groups[a][r.integers(0, len(groups[a]), batch)]
                s = bank.size
                ys = r.integers(0, s - crop + 1, batch)
                xs = r.integers(0, s - crop + 1, batch)
                out = np.empty((batch, n_p + 1, crop, crop, 3), np.float32)
                for j in range(batch):
                    out[j] = bank.bank[sel[j], :n_p + 1, ys[j]:ys[j] + crop,
                                       xs[j]:xs[j] + crop] \
                        .astype(np.float32) / 255.0
                qp = int(np.clip(REF_QP_ANCHORS[a] + r.integers(-8, 9), 0,
                                 63))
                return out, qp
            return (bank.sample(r, batch, crop, t=n_p + 1),
                    int(r.integers(0, 64)))
        return gen

    return _campaign(
        out_ckpt, _dmc_params(seed),
        make_dmc_loss(lmbda_min, quant_mode="ste", lmbda_max=lmbda_max),
        _bounds(stages, total_steps), make_gen,
        lambda s: f"crop={s[0]} batch={s[1]} P={s[2]}",
        lambda p: _eval_probe_dmc(p, eval_seqs, EVAL_QPS, device),
        {"seed": seed, "total_steps": total_steps,
         "lmbda": [lmbda_min, lmbda_max]},
        total_steps, seed, base_lr, resume, save_every, log_every,
        eval_every, log_path, stop_after, amp, device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--model", choices=("dmci", "dmc"), default="dmci")
    ap.add_argument("--dmci_ckpt", default=None,
                    help="frozen trained DMCI for DMC ref recon")
    ap.add_argument("--steps", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--bank_images", type=int, default=512)
    ap.add_argument("--bank_size", type=int, default=320)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save_every", type=int, default=2000)
    ap.add_argument("--eval_every", type=int, default=10000)
    ap.add_argument("--log", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced-channel model (CI-scale, dmci only)")
    ap.add_argument("--amp", action="store_true",
                    help="bf16 forward/backward, f32 master weights")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the CPU "
                         "path)")
    args = ap.parse_args(argv)
    if args.model == "dmc":
        return train_dmc_campaign(
            args.out, dmci_ckpt=args.dmci_ckpt, total_steps=args.steps,
            seed=args.seed, base_lr=args.lr, resume=args.resume,
            save_every=args.save_every, eval_every=args.eval_every,
            log_path=args.log, amp=args.amp, device=args.device)
    from ..eval.rd_evidence import TINY_KW
    return train_dmci_campaign(
        args.out, total_steps=args.steps, seed=args.seed,
        base_lr=args.lr, bank_images=args.bank_images,
        bank_size=args.bank_size, resume=args.resume,
        save_every=args.save_every, eval_every=args.eval_every,
        log_path=args.log, model_kw=TINY_KW if args.tiny else {},
        amp=args.amp, device=args.device)


if __name__ == "__main__":
    main()
