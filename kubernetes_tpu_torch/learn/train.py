"""The learned scorer's parameters (the parameter half of the JAX
package's learn/train.py).

``init_params`` draws a He-initialised layer stack from an explicit
``torch.Generator``: its bits are not ``jax.random``'s, so a test that
compares the packages carries the JAX package's numpy params across
(convert.learned_params) instead of seeding both. ``identity_params``
is the differential-test fixture. The trainer (``train``, ``_fit``,
``_adam_step``) is the training slice's (ROADMAP queue 1 item 18).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from kubernetes_tpu_torch.ops.learned import (
    MAX_SCORE,
    NUM_FEATURES,
    hand_weight_vector,
)


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
