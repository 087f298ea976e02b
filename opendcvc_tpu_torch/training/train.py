"""RD training on one device or a grid of ranks: losses, optax's
schedules and optimizer rules, reduce-on-plateau, the train step.

Counterpart of the JAX package's `training/train.py`: the losses of DMCI,
DMC, DCVC-TCM, DCVC-FM and DCVC (its staged loss and the stage-dependent
freeze of its motion branch).
optax is re-expressed by hand, rule for rule, so the port steps as the JAX
package does:
  * a schedule is evaluated at the update count before the update (so
    with warmup the first update has lr 0: Adam's moments move, the
    parameters do not); `cosine` decays over total_steps counted from the
    end of the warmup, as `optax.join_schedules` joins it;
  * `optax.clip_by_global_norm`: the gradients scaled by max_norm / norm
    only when norm >= max_norm (torch's `clip_grad_norm_` adds 1e-6 and
    always scales, so it is not used);
  * `optax.adam`: m and v moments, bias-corrected, m_hat / (sqrt(v_hat) +
    1e-8), times -lr;
  * `optax.contrib.reduce_on_plateau` (optax 0.2.6), after Adam when
    make_optimizer gets `plateau=dict(...)`: a float32 running mean of the
    monitored loss over `accumulation_size` steps, then the plateau count,
    the cooldown and the scale (times `factor`, never below `min_scale`)
    updated, and the updates multiplied by the new scale.  Its state is
    device tensors and its branches torch.where, so a step never waits
    on the host for the loss.
Parameter trees are the codecs' nested dicts and lists of tensors; the
optimizer and the step work on their trainable leaves in one fixed order.
A leaf keyed "mask" (a masked convolution's causal mask) is not trained:
it takes no gradient, no Adam update and no part in the clip's norm, as
the reference keeps it a buffer.  The JAX package trains it like any
leaf, so there its zeros move (ROADMAP Queue 3).
"""

import contextlib
import math

import numpy as np
import torch
import torch.distributed as dist

from .forward import (DCVC_MOTION_SUBTREES, dcvc_forward,
                      dmc_fm_forward_one_frame, dmc_forward_one_frame,
                      dmc_tcm_forward_one_frame, dmci_forward,
                      stage_loss_dcvc)
from ..parallel.mesh import Shard, sharded

#: the keys of leaves the step never trains
FIXED_LEAVES = ("mask",)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_leaves(tree):
    """The leaves of a nested dict/list tree in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped as `like` holding `leaves` (tree_leaves' order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def _paths(tree, prefix=""):
    """'/'-joined key paths of the leaves, list indices written as JAX
    writes a sequence key ('[0]')."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}[{i}]/")]
    return [prefix[:-1]]


def _trainable(tree):
    """Per leaf, in tree_leaves' order: whether the step trains it."""
    return [p.rsplit("/", 1)[-1] not in FIXED_LEAVES for p in _paths(tree)]


def trainable_leaves(tree):
    """The leaves the optimizer works on: every leaf but FIXED_LEAVES',
    in tree_leaves' order."""
    return [t for t, k in zip(tree_leaves(tree), _trainable(tree)) if k]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def rd_loss(out, lmbda):
    """lambda * D + R."""
    return lmbda * out["mse"] + out["bpp"]


def lmbda_for_qp(qp, lmbda_min, lmbda_max, qp_num=64):
    """The qp's lambda, log-interpolated from lmbda_max (qp 0) to
    lmbda_min (qp qp_num - 1), in float32 as the JAX package computes
    it."""
    f32 = torch.float32
    t = 1.0 - torch.tensor(qp, dtype=f32) / (qp_num - 1)
    lo = torch.log(torch.tensor(lmbda_min, dtype=f32))
    hi = torch.log(torch.tensor(lmbda_max, dtype=f32))
    return torch.exp(lo + t * (hi - lo))


def make_dmci_loss(lmbda, qp_sampler=None, quant_mode="ste",
                   lmbda_max=None):
    """loss_fn(params, batch (B, H, W, 3), qp, rng) -> (loss, metrics)."""
    del qp_sampler      # as in the JAX package: the caller samples qp

    def loss_fn(params, batch, qp, rng):
        out = dmci_forward(params, batch, qp, rng, quant_mode)
        lm = lmbda if lmbda_max is None else \
            lmbda_for_qp(qp, lmbda, lmbda_max)
        loss = rd_loss(out, lm)
        metrics = {"loss": loss, "mse": out["mse"], "bpp": out["bpp"],
                   "bpp_y": out["bpp_y"], "bpp_z": out["bpp_z"]}
        return loss, metrics
    return loss_fn


def make_dmc_loss(lmbda, quant_mode="ste", lmbda_max=None):
    """Cascaded multi-frame loss: frames (B, T, H, W, 3); frame 0 is the
    pixel reference, and each later frame is coded from the previous
    frame's x_hat and feature, neither detached, so the gradient flows
    through the whole chain.  rng: a torch.Generator, or a sequence of
    T - 1 per-frame noise tensors for quant_mode "noise"."""
    def loss_fn(params, frames, qp, rng):
        lmbda_q = lmbda if lmbda_max is None else \
            lmbda_for_qp(qp, lmbda, lmbda_max)
        ref = frames[:, 0]
        n_frames = frames.shape[1] - 1
        feature = None
        total = 0.0
        metrics = {"mse": 0.0, "bpp": 0.0}
        for t in range(n_frames):
            r = rng[t] if isinstance(rng, (list, tuple)) else rng
            out = dmc_forward_one_frame(params, frames[:, t + 1], ref,
                                        feature, qp, r, quant_mode)
            total = total + rd_loss(out, lmbda_q)
            metrics["mse"] = metrics["mse"] + out["mse"] / n_frames
            metrics["bpp"] = metrics["bpp"] + out["bpp"] / n_frames
            feature = out["feature"]
            ref = out["x_hat"]
        loss = total / n_frames
        metrics["loss"] = loss
        return loss, metrics
    return loss_fn


def make_tcm_loss(lmbda, quant_mode="ste"):
    """Cascaded DCVC-TCM loss: frames (B, T, H, W, 3); frame 0 is the
    pixel reference, and each later frame is coded from the previous
    frame's x_hat and propagated feature, neither detached.  rng: a
    torch.Generator, or a sequence of T - 1 per-frame sequences of the
    four noise tensors `dmc_tcm_forward_one_frame` takes (quant_mode
    "noise").  qp is taken and unused, as in the JAX package."""
    def loss_fn(params, frames, qp, rng):
        del qp
        ref = frames[:, 0]
        feature = None
        n_frames = frames.shape[1] - 1
        total = 0.0
        metrics = {"mse": 0.0, "bpp": 0.0, "warp_mse": 0.0}
        for t in range(n_frames):
            r = rng[t] if isinstance(rng, (list, tuple)) else rng
            out = dmc_tcm_forward_one_frame(params, frames[:, t + 1], ref,
                                            feature, r, quant_mode)
            total = total + rd_loss(out, lmbda)
            for k in metrics:
                metrics[k] = metrics[k] + out[k] / n_frames
            ref = out["x_hat"]
            feature = out["feature"]
        loss = total / n_frames
        metrics["loss"] = loss
        return loss, metrics
    return loss_fn


def make_fm_loss(lmbda_min, lmbda_max, quant_mode="ste"):
    """Cascaded DCVC-FM loss: one model over the whole q_index range 0-63.
    The caller samples q_index per step and passes it as `qp`; the loss
    weight is lmbda_for_qp(63 - qp): FM's q_index runs from low to high
    rate, the reverse of the banked models' qp ladder.  frames (B, T, H,
    W, 3): frame 0 is the pixel reference; each later frame is coded from
    the previous frame's full DPB (x_hat, feature, mv_feature, y_hat,
    mv_y_hat), none detached, with fa_idx = t % 3 as the codec cycles it.
    rng: a torch.Generator, or a sequence of T - 1 per-frame pairs of the
    noise tensors `dmc_fm_forward_one_frame` takes."""
    def loss_fn(params, frames, qp, rng):
        lmbda_q = lmbda_for_qp(63 - qp, lmbda_min, lmbda_max, qp_num=64)
        ref = frames[:, 0]
        feature = mv_feature = ref_y = ref_mv_y = None
        n_frames = frames.shape[1] - 1
        total = 0.0
        metrics = {"mse": 0.0, "bpp": 0.0, "warp_mse": 0.0}
        for t in range(n_frames):
            r = rng[t] if isinstance(rng, (list, tuple)) else rng
            out = dmc_fm_forward_one_frame(
                params, frames[:, t + 1], ref, feature, mv_feature, ref_y,
                ref_mv_y, qp, r, quant_mode, fa_idx=t % 3)
            total = total + rd_loss(out, lmbda_q)
            for k in metrics:
                metrics[k] = metrics[k] + out[k] / n_frames
            ref = out["x_hat"]
            feature = out["feature"]
            mv_feature = out["mv_feature"]
            ref_y = out["y_hat"]
            ref_mv_y = out["mv_y_hat"]
        loss = total / n_frames
        metrics["loss"] = loss
        return loss, metrics
    return loss_fn


def make_dcvc_loss(lmbda, stage=4, quant_mode="noise"):
    """DCVC's staged loss over cascaded frames (B, T, H, W, 3): frame 0 is
    the pixel reference; in stages 1-3 each later frame is coded from the
    previous frame's x_hat detached, in stage 4 not detached, so the
    gradient flows through the chain.  rng: a torch.Generator, or a
    sequence of T - 1 per-frame sequences of the four noise tensors
    `dcvc_forward` takes.  qp is taken and unused (DCVC has no QP
    banks)."""
    def loss_fn(params, frames, qp, rng):
        del qp
        ref = frames[:, 0]
        n_frames = frames.shape[1] - 1
        total = 0.0
        metrics = {"mse": 0.0, "bpp": 0.0, "warp_mse": 0.0, "bpp_mv": 0.0}
        for t in range(n_frames):
            r = rng[t] if isinstance(rng, (list, tuple)) else rng
            out = dcvc_forward(params, frames[:, t + 1], ref, r, stage=stage,
                               quant_mode=quant_mode)
            total = total + stage_loss_dcvc(out, lmbda, stage)
            metrics["mse"] = metrics["mse"] + out["mse"] / n_frames
            metrics["warp_mse"] = metrics["warp_mse"] \
                + out["warp_mse"] / n_frames
            metrics["bpp"] = metrics["bpp"] + out["bpp"] / n_frames
            metrics["bpp_mv"] = metrics["bpp_mv"] \
                + (out["bpp_mv_y"] + out["bpp_mv_z"]) / n_frames
            ref = out["x_hat"] if stage == 4 else out["x_hat"].detach()
        loss = total / n_frames
        metrics["loss"] = loss
        return loss, metrics
    return loss_fn


def dcvc_stage_grad_transform(stage):
    """Stages 2-3 freeze the motion branch (its gradients zeroed); None in
    stages 1 and 4."""
    if stage in (2, 3):
        return lambda grads: freeze_subtree(grads, DCVC_MOTION_SUBTREES)
    return None


# ---------------------------------------------------------------------------
# schedules (optax's, evaluated at the update count)
# ---------------------------------------------------------------------------

def _exponential_decay(init, transition_steps, decay_rate):
    """optax.exponential_decay(staircase=True)."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init
    return lambda count: init if count <= 0 else \
        init * decay_rate ** math.floor(count / transition_steps)


def _piecewise_constant(init, boundaries_and_scales):
    """optax.piecewise_constant_schedule: each scale applies from its
    boundary on (count >= boundary)."""
    items = sorted(boundaries_and_scales.items())

    def sched(count):
        v = init
        for threshold, scale in items:
            if count >= threshold:
                v = v * scale
        return v
    return sched


def _cosine_decay(init, decay_steps, alpha):
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def sched(count):
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c
                                                          / decay_steps))
                       + alpha)
    return sched


def _linear(init, end, steps):
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps)
                                         / steps) + end


def make_schedule(kind, base_lr, total_steps, warmup_steps=0, **kw):
    """The learning rate as a function of the update count (0 for the
    first update): "constant", "step" (step_size, default total_steps //
    3, gamma 0.1), "multistep" (milestones, gamma 0.1) or "cosine" (to
    min_ratio 0.01 of base_lr over total_steps), after warmup_steps of
    linear warmup from 0 when warmup_steps > 0."""
    if kind == "constant":
        sched = lambda count: base_lr       # noqa: E731
    elif kind == "step":
        sched = _exponential_decay(base_lr, kw.get("step_size",
                                                   total_steps // 3),
                                   kw.get("gamma", 0.1))
    elif kind == "multistep":
        sched = _piecewise_constant(base_lr, {int(b): kw.get("gamma", 0.1)
                                              for b in kw.get("milestones",
                                                              [])})
    elif kind == "cosine":
        sched = _cosine_decay(base_lr, total_steps, kw.get("min_ratio", 0.01))
    else:
        raise ValueError(kind)
    if warmup_steps > 0:
        warm, after = _linear(0.0, base_lr, warmup_steps), sched
        sched = lambda count: warm(count) if count < warmup_steps \
            else after(count - warmup_steps)     # noqa: E731
    return sched


# ---------------------------------------------------------------------------
# optimizer: clip_by_global_norm, then adam, then reduce-on-plateau
# ---------------------------------------------------------------------------

_INT32_MAX = 2 ** 31 - 1


class ReduceOnPlateau:
    """optax.contrib.reduce_on_plateau (optax 0.2.6) on device tensors.
    `init(device)` -> the state {"avg_value", "best_value",
    "cooldown_count", "count", "plateau_count", "scale"} (float32 and
    int32 0-dim tensors, as optax's); `update(state, value)` -> (the new
    scale, the new state).  Every comparison is a torch.where, so the host
    never reads the loss."""

    def __init__(self, factor=0.1, patience=10, rtol=1e-4, atol=0.0,
                 cooldown=0, accumulation_size=1, min_scale=0.0):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"Factor must be in the range (0, 1), got "
                             f"factor = {factor}.")
        if rtol < 0.0 or atol < 0.0:
            raise ValueError(f"Both rtol and atol must be non-negative, got "
                             f"rtol = {rtol} and atol = {atol}.")
        if rtol == 0.0 and atol == 0.0:
            raise ValueError(f"At least one of rtol or atol must be "
                             f"positive, got rtol = {rtol} and atol = "
                             f"{atol}.")
        if rtol > 1.0:
            raise ValueError(f"rtol must be less than or equal to 1.0, got "
                             f"rtol = {rtol}.")
        # optax multiplies float32 arrays by these Python floats, which
        # JAX rounds to float32 first
        self.factor = float(np.float32(factor))
        self.keep = float(np.float32(1 - rtol))
        self.atol = float(np.float32(atol))
        self.min_scale = float(np.float32(min_scale))
        self.patience = patience
        self.cooldown = cooldown
        self.accumulation_size = accumulation_size

    def init(self, device):
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=device)

        return {"avg_value": f32(0.0), "best_value": f32(float("inf")),
                "cooldown_count": i32(0), "count": i32(0),
                "plateau_count": i32(0), "scale": f32(1.0)}

    def update(self, state, value):
        f32 = torch.float32
        count = state["count"]
        new_count = torch.where(count < _INT32_MAX, count + 1, count)
        avg = (count.to(f32) * state["avg_value"] + value.detach().to(f32)) \
            / new_count.to(f32)
        best = state["best_value"]
        zero = torch.zeros_like(count)
        # _update_scale, taken when new_count reaches accumulation_size
        improved = avg < best * self.keep - self.atol
        new_best = torch.where(improved, avg, best)
        plateau = state["plateau_count"]
        curr = torch.where(improved, zero, torch.where(
            plateau < _INT32_MAX, plateau + 1, plateau))
        hit = curr == self.patience
        cooling = state["cooldown_count"] > 0
        scale = state["scale"]
        hot_scale = torch.clamp_min(
            torch.where(hit, scale * self.factor, scale), self.min_scale)
        new_plateau = torch.where(cooling, zero,
                                  torch.where(hit, zero, curr))
        new_scale = torch.where(cooling, scale, hot_scale)
        new_cool = torch.where(
            cooling, state["cooldown_count"] - 1,
            torch.where(hit, torch.full_like(count, self.cooldown), zero))
        fire = new_count == self.accumulation_size
        out = {"avg_value": torch.where(fire, torch.zeros_like(avg), avg),
               "best_value": torch.where(fire, new_best, best),
               "cooldown_count": torch.where(fire, new_cool,
                                             state["cooldown_count"]),
               "count": torch.where(fire, zero, new_count),
               "plateau_count": torch.where(fire, new_plateau, plateau),
               "scale": torch.where(fire, new_scale, scale)}
        return out["scale"], out


class Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip), adam(schedule)[,
    reduce_on_plateau(**plateau)]) on lists of leaves.  `init(leaves)` ->
    state {"count", "mu", "nu"[, "plateau"]}; `update(grads, state,
    value=None)` -> (updates, state), `value` the monitored loss (a
    tensor), which the plateau needs; the caller adds the updates to the
    parameters."""

    def __init__(self, schedule, grad_clip=1.0, b1=0.9, b2=0.999,
                 eps=1e-8, plateau=None):
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.plateau = None if plateau is None else ReduceOnPlateau(**plateau)

    def init(self, leaves):
        state = {"count": 0, "mu": [torch.zeros_like(t) for t in leaves],
                 "nu": [torch.zeros_like(t) for t in leaves]}
        if self.plateau is not None:
            state["plateau"] = self.plateau.init(leaves[0].device)
        return state

    def update(self, grads, state, value=None):
        grads = list(grads)
        # optax's select(norm < clip, g, (g / norm) * clip), on the device
        # so the host never waits for the backward: below the clip the
        # same ops run with 1 for norm and clip, which leaves g exact
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        keep = norm < self.grad_clip
        one = torch.ones_like(norm)
        grads = torch._foreach_mul(
            torch._foreach_div(grads, torch.where(keep, one, norm)),
            torch.where(keep, one, torch.full_like(norm, self.grad_clip)))
        count = state["count"]
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        # the bias corrections in float32, as optax computes them
        n = np.float32(count + 1)
        c1 = float(np.float32(1) - np.float32(self.b1) ** n)
        c2 = float(np.float32(1) - np.float32(self.b2) ** n)
        den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(den, self.eps)
        updates = torch._foreach_div(torch._foreach_div(mu, c1), den)
        torch._foreach_mul_(updates, -float(np.float32(self.schedule(count))))
        out = {"count": count + 1, "mu": mu, "nu": nu}
        if self.plateau is not None:
            if value is None:
                raise ValueError("reduce-on-plateau needs the monitored "
                                 "loss: update(grads, state, value=loss)")
            scale, out["plateau"] = self.plateau.update(state["plateau"],
                                                        value)
            torch._foreach_mul_(updates, scale)
        return updates, out


def make_optimizer(base_lr=1e-4, schedule="constant", total_steps=1_000_000,
                   warmup_steps=0, grad_clip=1.0, plateau=None, **kw):
    """Global-norm clipping, then Adam on make_schedule's learning rate,
    then, with plateau=dict(factor=..., patience=..., ...), the
    reduce-on-plateau scale (whose update needs the monitored loss: pass
    plateau=True to make_train_step)."""
    return Optimizer(make_schedule(schedule, base_lr, total_steps,
                                   warmup_steps, **kw), grad_clip,
                     plateau=plateau)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _cast(t, dtype):
    return t.to(dtype) if t.is_floating_point() else t


def _all_reduce(loss, metrics, grads, zero):
    """One all-reduce, a sum over every rank, of the loss, the metrics and
    the gradients packed into one float32 buffer (a rank with `zero`
    adds zeros); returns them unpacked, each scalar in its dtype."""
    keys = list(metrics)
    scalars = [loss] + [metrics[k] for k in keys]
    flat = torch.cat([torch.as_tensor(v).detach().float().reshape(1)
                      .to(grads[0].device) for v in scalars]
                     + [g.reshape(-1) for g in grads])
    if zero:
        flat.zero_()
    dist.all_reduce(flat)
    out = torch.split(flat, [1] * len(scalars) + [g.numel() for g in grads])
    vals = [o.reshape(()).to(v.dtype) if isinstance(v, torch.Tensor)
            else o.reshape(()) for o, v in zip(out, scalars)]
    # each gradient in a tensor of its own, as the optimizer reads them on
    # one device
    grads = [o.view(g.shape).clone() for o, g in
             zip(out[len(scalars):], grads)]
    return vals[0], dict(zip(keys, vals[1:])), grads


def make_train_step(loss_fn, tx, compute_dtype=None, grad_transform=None,
                    plateau=False, mesh=None, spatial=False):
    """step(params, opt_state, batch, qp, rng) -> (params, opt_state,
    metrics) on one device; the parameters are updated in place (the step
    makes their leaves require grad) and returned.

    With a mesh (`parallel/mesh.py::make_mesh`), `batch` is this rank's
    block of the global batch (`batch_sharding`): rows over "data", and
    with spatial=True the frames' rows over "spatial" (DMCI and DMC only),
    else the spatial axis holds replicas, which add nothing.  Each rank
    runs the loss as its share of the global one (`sharded`), then the
    loss, the metrics and the gradients are summed over the ranks in one
    all-reduce before the clip's global norm, so the plateau sees the
    global loss, the metrics are global and every rank applies the same
    update: the parameters stay replicated.  The noise generator `rng`
    must be seeded alike on every rank.

    compute_dtype=torch.bfloat16 is the JAX package's AMP policy: the
    parameters and the batch are cast inside the differentiated function,
    so the casts are part of the graph and the gradients land on the
    float32 leaves; parameters and optimizer state stay float32.
    grad_transform edits the gradient tree before the optimizer (the
    parameter-freeze hook, e.g. freeze_subtree); a fixed leaf's gradient
    in that tree is zero.  The optimizer state is over
    trainable_leaves(params).  plateau=True passes the loss to the
    optimizer as the monitored value (float32, as optax's astype makes
    it), for make_optimizer(plateau=...)."""

    shard = None if mesh is None else Shard(mesh, spatial)
    replica = shard is not None and not spatial and \
        mesh.index("spatial") > 0

    def step(params, opt_state, batch, qp, rng):
        all_leaves = tree_leaves(params)
        keep = _trainable(params)
        leaves = [t for t, k in zip(all_leaves, keep) if k]
        for t in leaves:
            if not t.requires_grad:
                t.requires_grad_(True)
        scope = contextlib.nullcontext() if shard is None else \
            sharded(shard)
        with torch.enable_grad(), scope:
            if compute_dtype is not None:
                use = tree_unflatten(params, [_cast(t, compute_dtype)
                                              for t in all_leaves])
                batch = _cast(batch, compute_dtype)
            else:
                use = params
            loss, metrics = loss_fn(use, batch, qp, rng)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        if grad_transform is not None:
            it = iter(grads)
            full = [next(it) if k else torch.zeros_like(t)
                    for t, k in zip(all_leaves, keep)]
            full = tree_leaves(grad_transform(tree_unflatten(params, full)))
            grads = [g for g, k in zip(full, keep) if k]
        if shard is not None:
            loss, metrics, grads = _all_reduce(loss, metrics, grads,
                                               replica)
        if plateau:
            updates, opt_state = tx.update(grads, opt_state,
                                           value=loss.detach())
        else:
            updates, opt_state = tx.update(grads, opt_state)
        with torch.no_grad():
            torch._foreach_add_(leaves, updates)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return params, opt_state, metrics

    return step


def freeze_subtree(grads, frozen_paths):
    """Zero the gradients of every leaf whose key path contains one of
    `frozen_paths`."""
    leaves = tree_leaves(grads)
    return tree_unflatten(grads, [
        torch.zeros_like(g) if any(f in path for f in frozen_paths) else g
        for path, g in zip(_paths(grads), leaves)])
