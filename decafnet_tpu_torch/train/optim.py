"""Optimizer, learning-rate schedules, gradient clipping and EMA (port of
decafnet_tpu/train/optim.py, which builds an optax chain).

* AdamW's weight decay applies to the conv kernels only: a parameter
  decays when its name is ``weight`` and it has 3 dimensions
  (:func:`decay_mask`).
* The schedules are the JAX package's closed forms in f32: linear warmup
  ``base * t / (warmup_itrs - 1)`` (the base rate from the start when
  warmup_itrs <= 1), then cosine to 1e-8 or step decay at the strictly
  positive milestones (``steps: (-1,)`` never decays), or a constant.
* :class:`Optimizer` is optax's chain step for step: clip the global norm of
  the gradients (``g * max / |g|`` when ``|g| >= max``, no epsilon), then
  AdamW / Adam (optax's ``scale_by_adam``, with its bias corrections
  ``1 - b ** t`` in f32) or SGD with momentum (optax's ``trace``), at
  ``lr(t)`` for the step count t *before* it increments; the update is
  added to the weights. Written out in ``torch._foreach`` ops rather than
  taken from ``torch.optim``, whose bias corrections are f64 and move an
  early AdamW step by ~1e-5 against optax.
* :func:`ema_update` is ``p + beta * (e - p)`` in that order.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def decay_mask(named_params):
    """{name: True where weight decay applies} for ``named_parameters()``."""
    return {name: name.rsplit(".", 1)[-1] == "weight" and p.ndim == 3
            for name, p in named_params}


def warmup_cosine_schedule(base_lr, warmup_itrs, total_itrs, eta_min=1e-8):
    """lr(t): linear 0 -> base over warmup, cosine base -> eta_min after."""
    f32 = np.float32
    denom = max(total_itrs - warmup_itrs, 1)

    def fn(t):
        t = f32(t)
        if t < warmup_itrs:
            if warmup_itrs > 1:
                return float(f32(base_lr) * t / f32(warmup_itrs - 1))
            return float(f32(base_lr))
        cos = np.cos(f32(math.pi) * (t - f32(warmup_itrs)) / f32(denom))
        return float(f32(eta_min) + f32(0.5) * f32(base_lr - eta_min)
                     * (f32(1.0) + cos))
    return fn


def warmup_multistep_schedule(base_lr, warmup_itrs, milestones, gamma=0.1):
    """lr(t): linear warmup, then ``base * gamma ** n`` with n the strictly
    positive milestones m passed (t - warmup_itrs >= m)."""
    f32 = np.float32
    ms = sorted(m for m in milestones if m > 0)

    def fn(t):
        t = f32(t)
        if t < warmup_itrs:
            if warmup_itrs > 1:
                return float(f32(base_lr) * t / f32(warmup_itrs - 1))
            return float(f32(base_lr))
        n_passed = f32(sum(t - f32(warmup_itrs) >= m for m in ms))
        return float(f32(base_lr) * f32(gamma) ** n_passed)
    return fn


def make_schedule(cfg_sched, itrs_per_epoch):
    """The lr schedule of the ``scheduler`` config subtree (``_base_lr``
    holds ``optimizer.lr``)."""
    warmup_itrs = cfg_sched.get("warmup_epochs", 0) * itrs_per_epoch
    name = cfg_sched["name"]
    base_lr = cfg_sched["_base_lr"]
    if name == "cosine":
        total = warmup_itrs + cfg_sched["epochs"] * itrs_per_epoch
        return warmup_cosine_schedule(base_lr, warmup_itrs, total)
    if name == "multistep":
        ms = [itrs_per_epoch * s for s in cfg_sched.get("steps", ())]
        return warmup_multistep_schedule(base_lr, warmup_itrs, ms,
                                         cfg_sched.get("gamma", 0.1))
    if name == "null":
        return lambda t: float(np.float32(base_lr))
    raise NotImplementedError(f"invalid scheduler: {name}")


@torch.no_grad()
def clip_grad_global_norm_(grads, max_norm):
    """optax ``clip_by_global_norm`` on a list of gradients, in place: with
    ``n`` the L2 norm of all of them together, each becomes
    ``g / n * max_norm`` when ``n >= max_norm`` (no epsilon, unlike
    ``clip_grad_norm_``); below the limit they stay bit for bit. Returns n
    (a 0-d tensor; no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    below = norm < max_norm
    for g in grads:
        g.copy_(torch.where(below, g, g / norm * max_norm))
    return norm


def _bias_correction(decay, t):
    """optax's ``1 - decay ** t`` for step t, in f32."""
    f32 = torch.float32
    return float(1 - torch.tensor(decay, dtype=f32) ** torch.tensor(t, dtype=f32))


class Optimizer:
    """The optimizer chain of ``cfg.optimizer`` over ``model``'s parameters:
    optional global-norm clipping, then ``adamw`` (b1 0.9, b2 0.999, eps
    1e-8, decay on :func:`decay_mask`), ``adam`` or ``sgd`` (momentum), at
    ``schedule(t)``. ``count`` is optax's step count t; ``state`` holds the
    moments (``mu``, ``nu``) or the momentum ``trace``, one tensor per
    parameter in ``model.named_parameters()`` order."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, model, cfg_optimizer, schedule):
        self.name = cfg_optimizer["name"]
        if self.name not in ("adamw", "adam", "sgd"):
            raise NotImplementedError(f"invalid optimizer: {self.name}")
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        self.schedule = schedule
        self.clip = cfg_optimizer.get("clip_grad_norm")
        self.momentum = cfg_optimizer.get("momentum", 0.9)
        mask = decay_mask(named)
        self.weight_decay = (cfg_optimizer.get("weight_decay", 0.0)
                             if self.name == "adamw" else 0.0)
        self.decays = [mask[n] for n, _ in named]
        self.count = 0
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.state = ({"trace": zeros()} if self.name == "sgd"
                      else {"mu": zeros(), "nu": zeros()})

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        """One update from the parameters' ``.grad`` (a missing gradient
        counts as zero, as in optax). Returns the lr it used."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.clip:
            clip_grad_global_norm_(grads, self.clip)
        lr = self.schedule(self.count)
        self.count += 1
        if self.name == "sgd":
            # optax trace: t <- g + momentum * t; the update is t
            trace = self.state["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            updates = torch._foreach_mul(trace, -lr)
        else:
            # optax scale_by_adam: moments (1 - b) * g + b * m, bias
            # corrections at the incremented count, eps outside the sqrt
            b1, b2 = self.B1, self.B2
            mu, nu = self.state["mu"], self.state["nu"]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
            denom = torch._foreach_div(nu, _bias_correction(b2, self.count))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.EPS)
            updates = torch._foreach_div(mu, _bias_correction(b1, self.count))
            torch._foreach_div_(updates, denom)
            if self.weight_decay:
                # optax add_decayed_weights on the masked leaves
                for u, p, decays in zip(updates, self.params, self.decays):
                    if decays:
                        u.add_(p * self.weight_decay)
            torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(self.params, updates)
        return lr

    def state_dict(self):
        return {"name": self.name, "count": self.count,
                **{k: [t.detach().cpu() for t in v]
                   for k, v in self.state.items()}}

    def load_state_dict(self, state):
        if state["name"] != self.name:
            raise ValueError(f"optimizer state of {state['name']!r}, not "
                             f"{self.name!r}")
        self.count = int(state["count"])
        for k, tensors in self.state.items():
            for t, saved in zip(tensors, state[k], strict=True):
                t.copy_(saved)


@torch.no_grad()
def ema_update(params, ema_params, beta):
    """``e <- p + beta * (e - p)`` for each pair, in place on ``e``."""
    params, ema_params = list(params), list(ema_params)
    torch._foreach_sub_(ema_params, params)
    torch._foreach_mul_(ema_params, beta)
    torch._foreach_add_(ema_params, params)
