"""Offline MLP trainer for the learned scorer (port of the JAX package's
learn/train.py), deterministic given a seed.

Two phases, as in the reference: behavior cloning (full-batch Adam on the
MSE between the MLP output and the hand-tuned aggregate rescaled to
[0, 100]), then a reward-weighted fine-tune (targets nudged by each
example's outcome advantage, samples weighted by 1 + |advantage|).

The step is kernel K10 (csrc/learned_train.cu, prepared once a fit as
kernels/learned.py TrainStep): on the card ONE launch gives the loss and
the gradient of every packed parameter, reduced in a fixed order, so two
runs with the same seed and dataset give bit-identical checkpoints. On the CPU the step is K10's twin, torch
autograd of the same loss (the reference's ``jax.value_and_grad``). The
parameters live as ONE packed buffer (kernels/learned.py LearnedParams'
layout) for the whole fit; the Adam update runs as plain torch ops on it,
as the reference's runs outside its jitted step.

``init_params`` draws a He-initialised layer stack from an explicit
``torch.Generator``: its bits are not ``jax.random``'s, so a test that
compares the packages carries the JAX package's params across
(convert.learned_params). ``identity_params`` is the differential-test
fixture. Entry points run on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch.kernels import learned as KL
from kubernetes_tpu_torch.learn.replay import ReplayDataset
from kubernetes_tpu_torch.ops.learned import (
    MAX_SCORE,
    NUM_FEATURES,
    hand_weight_vector,
)


@dataclass
class TrainConfig:
    hidden: tuple = (8,)
    seed: int = 0
    bc_epochs: int = 300
    ft_epochs: int = 150
    lr: float = 0.03
    ft_lr: float = 0.005
    # score points a one-unit outcome advantage moves the target by
    ft_gain: float = 25.0
    meta: dict = field(default_factory=dict)


def init_params(seed: int, hidden: tuple = (8,),
                num_features: int = NUM_FEATURES):
    """He-initialised ((W, b), ...) layer stack of float32 CPU tensors,
    scalar head: W ~ N(0, 2 / fan_in), b = 0."""
    gen = torch.Generator().manual_seed(int(seed))
    sizes = (num_features,) + tuple(hidden) + (1,)
    params = []
    for i in range(len(sizes) - 1):
        scale = math.sqrt(2.0 / sizes[i])
        w = torch.randn((sizes[i], sizes[i + 1]), generator=gen,
                        dtype=torch.float32) * scale
        params.append((w, torch.zeros((sizes[i + 1],), dtype=torch.float32)))
    return tuple(params)


def identity_params():
    """A single linear layer reproducing the hand-tuned no-topology
    aggregate rescaled to [0, 100]: at any positive weight it only
    rescales the aggregate on topology-free batches, so placements match
    the baseline (numpy arrays, as the reference returns them)."""
    w = np.zeros((NUM_FEATURES, 1), np.float32)
    hand = hand_weight_vector()
    # features are score/100, so out = sum(w_i * s_i) / sum(w) in [0,100]
    w[:, 0] = hand * (MAX_SCORE / hand.sum())
    return ((w, np.zeros((1,), np.float32)),)


def pack(params, device) -> tuple[torch.Tensor, tuple]:
    """(packed float32 buffer on ``device``, widths) of a ((W, b), ...)
    stack: W0 row-major, b0, W1, b1, ... (LearnedParams' layout)."""
    parts, dims = [], [int(np.asarray(params[0][0]).shape[0])]
    for w, b in params:
        w, b = (np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor)
                           else t, np.float32) for t in (w, b))
        parts += [w.reshape(-1), b.reshape(-1)]
        dims.append(int(w.shape[1]))
    buf = torch.from_numpy(np.ascontiguousarray(np.concatenate(parts)))
    return buf.to(device), tuple(dims)


def unpack_numpy(buf: torch.Tensor, dims: tuple) -> tuple:
    """The ((W, b), ...) numpy stack of a packed buffer."""
    flat = buf.detach().cpu().numpy().astype(np.float32)
    out, off = [], 0
    for din, dout in zip(dims[:-1], dims[1:]):
        w = flat[off:off + din * dout].reshape(din, dout).copy()
        off += din * dout
        out.append((w, flat[off:off + dout].copy()))
        off += dout
    return tuple(out)


def _adam_step(p, g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam update of the packed params (the reference's
    _adam_step, leaf by leaf the same elementwise operations)."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mh = m / (1 - b1 ** t)
    vh = v / (1 - b2 ** t)
    p = p - lr * mh / (torch.sqrt(vh) + eps)
    return p, m, v


def _fit(buf, dims, x, y, w, epochs, lr):
    """Full-batch weighted-MSE Adam over the packed params ``buf``;
    returns (params, first_loss, last_loss). On the card the K10 launch is
    prepared once (kernels/learned.py TrainStep): each step launches it
    into one gradient buffer and its slot of a losses buffer, read once at
    the end."""
    steps = max(epochs, 0)
    if not steps:
        return buf, None, None
    m = torch.zeros_like(buf)
    v = torch.zeros_like(buf)
    if buf.device.type == "cuda":
        step = KL.train_step(x.shape[0], dims, buf.device)
        step.check(buf, x, y, w)
        losses = torch.empty((steps,), dtype=torch.float32,
                             device=buf.device)
        g = torch.empty_like(buf)
        at, g_at = losses.data_ptr(), g.data_ptr()
        for t in range(1, steps + 1):
            step.launch(KL.MODE_GRAD, buf, x, y, w, at + 4 * (t - 1), g_at)
            buf, m, v = _adam_step(buf, g, m, v, t, lr)
        vals = losses[[0, -1]].cpu().tolist()
        return buf, float(vals[0]), float(vals[-1])
    first = None
    for t in range(1, steps + 1):
        loss, g = KL.mlp_value_and_grad(buf, dims, x, y, w)
        buf, m, v = _adam_step(buf, g, m, v, t, lr)
        if t == 1:
            first = loss
    return buf, float(first), float(loss)


def train(ds: ReplayDataset, cfg: Optional[TrainConfig] = None,
          device="cuda"):
    """Returns (params, info): params a ((W, b), ...) numpy stack ready
    for learn.checkpoint.save_checkpoint, info the training record that
    lands in the checkpoint meta. Runs on ``device`` (K10 on the card,
    its twin on the CPU)."""
    cfg = cfg or TrainConfig()
    if len(ds) == 0:
        raise ValueError("empty replay dataset")
    dev = torch.device(device)
    x = torch.as_tensor(np.asarray(ds.x, np.float32)).to(dev).contiguous()
    y = torch.as_tensor(np.asarray(ds.y, np.float32)).to(dev).contiguous()
    ones = torch.ones_like(y)
    buf, dims = pack(init_params(cfg.seed, cfg.hidden, ds.x.shape[1]), dev)
    buf, bc_first, bc_last = _fit(buf, dims, x, y, ones, cfg.bc_epochs,
                                  cfg.lr)
    info = {
        "seed": cfg.seed,
        "hidden": list(cfg.hidden),
        "examples": int(len(ds)),
        "bc_epochs": cfg.bc_epochs,
        "bc_loss_first": round(bc_first or 0.0, 4),
        "bc_loss_last": round(bc_last or 0.0, 4),
    }
    info.update(cfg.meta)
    if cfg.ft_epochs > 0:
        adv = torch.as_tensor(np.asarray(ds.reward, np.float32)).to(dev)
        adv = adv - torch.mean(adv)
        target = torch.clamp(y + cfg.ft_gain * adv, 0.0, MAX_SCORE)
        weight = 1.0 + torch.abs(adv)
        buf, ft_first, ft_last = _fit(buf, dims, x, target.contiguous(),
                                      weight.contiguous(), cfg.ft_epochs,
                                      cfg.ft_lr)
        info.update(ft_epochs=cfg.ft_epochs,
                    ft_loss_first=round(ft_first or 0.0, 4),
                    ft_loss_last=round(ft_last or 0.0, 4))
    return unpack_numpy(buf, dims), info
