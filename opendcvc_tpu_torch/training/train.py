"""RD training of DCVC-RT on one device: losses, optax's schedules and
optimizer rules, the train step.

Counterpart of the JAX package's `training/train.py`, cut to DMCI, DMC
and DCVC-TCM.
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
    1e-8), times -lr.
Parameter trees are the codecs' nested dicts and lists of tensors; the
optimizer and the step work on their leaves in one fixed order.  The
reduce-on-plateau option is not ported yet.
"""

import math

import numpy as np
import torch

from .forward import (dmc_forward_one_frame, dmc_tcm_forward_one_frame,
                      dmci_forward)

PLATEAU_NOT_PORTED = ("reduce-on-plateau (optax.contrib.reduce_on_plateau) "
                      "is not ported yet (ROADMAP Queue 1 item 6)")


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
# optimizer: clip_by_global_norm, then adam
# ---------------------------------------------------------------------------

class Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip), adam(schedule)) on
    lists of leaves.  `init(leaves)` -> state {"count", "mu", "nu"};
    `update(grads, state)` -> (updates, state); the caller adds the
    updates to the parameters."""

    def __init__(self, schedule, grad_clip=1.0, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, leaves):
        return {"count": 0, "mu": [torch.zeros_like(t) for t in leaves],
                "nu": [torch.zeros_like(t) for t in leaves]}

    def update(self, grads, state):
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
        return updates, {"count": count + 1, "mu": mu, "nu": nu}


def make_optimizer(base_lr=1e-4, schedule="constant", total_steps=1_000_000,
                   warmup_steps=0, grad_clip=1.0, plateau=None, **kw):
    """Global-norm clipping, then Adam on make_schedule's learning rate."""
    if plateau is not None:
        raise NotImplementedError(PLATEAU_NOT_PORTED)
    return Optimizer(make_schedule(schedule, base_lr, total_steps,
                                   warmup_steps, **kw), grad_clip)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _cast(t, dtype):
    return t.to(dtype) if t.is_floating_point() else t


def make_train_step(loss_fn, tx, compute_dtype=None, grad_transform=None,
                    plateau=False):
    """step(params, opt_state, batch, qp, rng) -> (params, opt_state,
    metrics) on one device; the parameters are updated in place (the step
    makes their leaves require grad) and returned.

    compute_dtype=torch.bfloat16 is the JAX package's AMP policy: the
    parameters and the batch are cast inside the differentiated function,
    so the casts are part of the graph and the gradients land on the
    float32 leaves; parameters and optimizer state stay float32.
    grad_transform edits the gradient tree before the optimizer (the
    parameter-freeze hook, e.g. freeze_subtree)."""
    if plateau:
        raise NotImplementedError(PLATEAU_NOT_PORTED)

    def step(params, opt_state, batch, qp, rng):
        leaves = tree_leaves(params)
        for t in leaves:
            if not t.requires_grad:
                t.requires_grad_(True)
        with torch.enable_grad():
            if compute_dtype is not None:
                use = tree_unflatten(params, [_cast(t, compute_dtype)
                                              for t in leaves])
                batch = _cast(batch, compute_dtype)
            else:
                use = params
            loss, metrics = loss_fn(use, batch, qp, rng)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        if grad_transform is not None:
            grads = tree_leaves(grad_transform(tree_unflatten(params, grads)))
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
