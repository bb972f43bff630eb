"""K10's one-launch design (csrc/learned_train.cu) as a numpy model on
the CPU, where the kernel cannot run, on both its paths (the narrow one
for 9 -> H -> 1 with H <= 8, k10_small; the tiled one, k10_step): the
same plan (kernels/learned.py plan_train), the same unit layout and parameter indexing (the Stack's
wo / bo / ao tables, tile_sum's parameter -> (layer, input, output)
mapping), the forward's and the backward's sums in the kernel's orders,
each tile's per-parameter sums added to the block's running sums, and
the last block's fold of the blocks' sums, each in the kernel's order
(four chains, row r into chain r % 4; the blocks' rows folded by groups
of TRAIN_GROUP in block order, then the groups in group order). Held against jax.value_and_grad of the reference's loss (loss to
1e-5, gradient to 1e-4 of its largest entry, as chip_smoke.py holds the
kernel to the twin), in both modes, with tiles past one a block."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests.torch_port_support  # noqa: F401  (thread cap)
from kubernetes_tpu.ops.learned import mlp_apply
from kubernetes_tpu_torch.kernels import learned as KL

pytestmark = pytest.mark.torch_port

# the package's train module (kubernetes_tpu.learn exports a function of
# the same name)
JT = importlib.import_module("kubernetes_tpu.learn.train")
IN_F = 9
f32 = np.float32


def _stack(dims):
    """The kernel's Stack: W and b offsets, and each layer's first unit
    (units 0 .. 8 are x)."""
    wo, bo, ao = [], [], []
    p, a = 0, IN_F
    for din, dout in zip(dims[:-1], dims[1:]):
        wo.append(p)
        p += din * dout
        bo.append(p)
        p += dout
        ao.append(a)
        a += dout
    wo.append(p)
    return wo, bo, ao


def _relu(v):
    return np.where(v > f32(0), v, f32(0))


def _sum4(terms):
    """csrc/learned_train.cu sum4 over the columns of ``terms``: item r
    into chain r % 4, each in order, then (c0 + c1) + (c2 + c3)."""
    chains = [np.zeros(terms.shape[:-1], f32) for _ in range(4)]
    for r in range(terms.shape[-1]):
        chains[r % 4] = chains[r % 4] + terms[..., r]
    return (chains[0] + chains[1]) + (chains[2] + chains[3])


def _fold(part):
    """The fold of the blocks' sums [blocks, n]: each group of
    TRAIN_GROUP blocks' rows in block order (sum4), then the groups' rows
    in group order (sum4)."""
    groups = [_sum4(part[g:g + KL.TRAIN_GROUP].T)
              for g in range(0, part.shape[0], KL.TRAIN_GROUP)]
    return _sum4(np.stack(groups).T)


def k10_model(params, dims, x, y, w, mode, plan):
    """(loss, grad or None) as csrc/learned_train.cu k10_step computes
    them under ``plan``."""
    m, n_l = x.shape[0], len(dims) - 1
    s_units = sum(dims[1:])
    n_p = KL.n_params(dims)
    wo, bo, ao = _stack(dims)
    first = 0 if mode == KL.MODE_GRAD else n_p
    t_rows = plan.threads
    part = np.zeros((plan.blocks, n_p + 1), f32)
    for blk in range(plan.blocks):
        acc = np.zeros((n_p + 1 - first,), f32)
        for t in range(plan.tiles):
            r0 = (blk * plan.tiles + t) * t_rows
            if r0 >= m:
                break
            rows = min(t_rows, m - r0)
            idx = slice(r0, r0 + rows)
            act = np.zeros((IN_F + s_units, rows), f32)
            dl = np.zeros((s_units, rows), f32)
            act[:IN_F] = x[idx].T
            for li in range(n_l):
                din, dout = dims[li], dims[li + 1]
                wm = params[wo[li]:bo[li]].reshape(din, dout)
                b = params[bo[li]:bo[li] + dout]
                in0 = 0 if li == 0 else ao[li - 1]
                a_in = act[in0:in0 + din]
                if li:
                    a_in = _relu(a_in)
                z = a_in[0][None, :] * wm[0][:, None]
                for k in range(1, din):
                    z = z + a_in[k][None, :] * wm[k][:, None]
                act[ao[li]:ao[li] + dout] = z + b[:, None]
            top = n_l - 1
            e = act[ao[top]] - y[idx]
            lrow = w[idx] * (e * e)
            if mode == KL.MODE_GRAD:
                dl[ao[top] - IN_F] = ((f32(2) * w[idx]) * e) / f32(m)
                for li in range(top, 0, -1):
                    din, dout = dims[li], dims[li + 1]
                    wm = params[wo[li]:bo[li]].reshape(din, dout)
                    d = dl[ao[li] - IN_F:ao[li] - IN_F + dout]
                    for k in range(din):
                        g = wm[k, 0] * d[0]
                        for j in range(1, dout):
                            g = g + wm[k, j] * d[j]
                        u = ao[li - 1] + k
                        dl[u - IN_F] = np.where(act[u] > f32(0), g, f32(0))
            # tile_sum: each parameter's contribution row by row
            contrib = np.zeros((n_p + 1, rows), f32)
            contrib[n_p] = lrow
            if mode == KL.MODE_GRAD:
                for p in range(n_p):
                    li = 0
                    while li + 1 < n_l and p >= wo[li + 1]:
                        li += 1
                    dout = dims[li + 1]
                    if p >= bo[li]:
                        contrib[p] = dl[ao[li] - IN_F + p - bo[li]]
                        continue
                    k, j = divmod(p - wo[li], dout)
                    a = (act[k] if li == 0
                         else _relu(act[ao[li - 1] + k]))
                    contrib[p] = a * dl[ao[li] - IN_F + j]
            tile = _sum4(contrib)
            acc = tile[first:] if t == 0 else acc + tile[first:]
        part[blk, first:] = acc
    total = _fold(part)
    loss = total[n_p] / f32(m)
    return loss, (total[:n_p] if mode == KL.MODE_GRAD else None)


def k10_small_model(params, dims, x, y, w, mode, plan):
    """(loss, grad or None) as csrc/learned_train.cu k10_small computes
    them under ``plan``: thread t of the grid takes rows t, t + blocks *
    threads, ... in order into a sum of each parameter; each warp's lanes
    joined by a fixed xor tree (as lane 0 sees it), warp 0's sum plus
    warp 1's; then the fold."""
    m, h = x.shape[0], dims[1]
    n_p = KL.n_params(dims)
    w0 = params[:9 * h].reshape(9, h)
    b0 = params[9 * h:10 * h]
    w1 = params[10 * h:11 * h]
    b1 = params[11 * h]
    n_t = plan.blocks * plan.threads
    acc = np.zeros((n_t, n_p + 1), f32)
    for it in range(plan.tiles):
        rows = np.arange(it * n_t, min((it + 1) * n_t, m))
        if not len(rows):
            break
        t = rows - it * n_t
        xr = x[rows]
        z = xr[:, 0][:, None] * w0[0][None, :]
        for k in range(1, 9):
            z = z + xr[:, k][:, None] * w0[k][None, :]
        z = z + b0[None, :]
        pred = _relu(z[:, 0]) * w1[0]
        for j in range(1, h):
            pred = pred + _relu(z[:, j]) * w1[j]
        pred = pred + b1
        e = pred - y[rows]
        acc[t, n_p] = acc[t, n_p] + w[rows] * (e * e)
        if mode == KL.MODE_GRAD:
            dp = ((f32(2) * w[rows]) * e) / f32(m)
            for j in range(h):
                d = np.where(z[:, j] > f32(0), w1[j] * dp, f32(0))
                for k in range(9):
                    acc[t, k * h + j] = acc[t, k * h + j] + xr[:, k] * d
                acc[t, 9 * h + j] = acc[t, 9 * h + j] + d
                acc[t, 10 * h + j] = (acc[t, 10 * h + j]
                                      + _relu(z[:, j]) * dp)
            acc[t, n_p - 1] = acc[t, n_p - 1] + dp
    part = np.zeros((plan.blocks, n_p + 1), f32)
    for blk in range(plan.blocks):
        warps = []
        for wp in range(plan.threads // 32):
            v = acc[blk * plan.threads + wp * 32:
                    blk * plan.threads + (wp + 1) * 32].copy()
            o = 16
            while o:
                v = v + v[np.arange(32) ^ o]
                o //= 2
            warps.append(v[0])
        total = warps[0]
        for v in warps[1:]:
            total = total + v
        part[blk] = total
    total = _fold(part)
    loss = total[n_p] / f32(m)
    return loss, (total[:n_p] if mode == KL.MODE_GRAD else None)


def _reference(params_tree, x, y, w):
    jp = tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in params_tree)
    loss, g = jax.value_and_grad(
        lambda p: jnp.mean(jnp.asarray(w) * (mlp_apply(p, jnp.asarray(x))
                                             - jnp.asarray(y)) ** 2))(jp)
    flat = np.concatenate([np.concatenate([np.asarray(a).ravel(),
                                           np.asarray(b).ravel()])
                           for a, b in g])
    return float(loss), flat


@pytest.mark.parametrize("hidden,m,sms", [
    ((8,), 2000, 1),        # the narrow path: 4 blocks, 8 rows a thread
    ((8,), 150, 132),       # a ragged last block
    ((3,), 900, 1),
    ((8,), 100_000, 132),   # 528 blocks: 17 groups of the fold
    ((16,), 2000, 1),       # tiled: 32 row tiles on 16 blocks, 2 a block
    ((16,), 300_000, 132),  # 1,563 blocks: 49 groups of the fold
    ((16, 8), 700, 2),
    ((4, 4, 4), 2333, 1),   # 37 row tiles on 16 blocks: 3 tiles a block
])
def test_k10_model_matches_value_and_grad(hidden, m, sms):
    rng = np.random.default_rng(len(hidden) * 31 + m)
    x = rng.uniform(0, 1, (m, IN_F)).astype(f32)
    y = rng.uniform(0, 100, m).astype(f32)
    w = (1 + rng.uniform(0, 2, m)).astype(f32)
    tree = tuple((np.asarray(a) * f32(3.0), np.asarray(b) + f32(0.1))
                 for a, b in JT.init_params(5, hidden))
    dims = (IN_F,) + tuple(hidden) + (1,)
    params = np.concatenate([np.concatenate([a.ravel(), b.ravel()])
                             for a, b in tree]).astype(f32)
    plan = KL.plan_train(m, dims, sms=sms)
    model = k10_small_model if plan.small else k10_model
    if sms == 1:
        assert plan.tiles > 1
    want_loss, want_grad = _reference(tree, x, y, w)
    loss, grad = model(params, dims, x, y, w, KL.MODE_GRAD, plan)
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    assert np.max(np.abs(grad - want_grad)) <= 1e-4 * np.max(
        np.abs(want_grad))
    loss_only, none = model(params, dims, x, y, w, KL.MODE_LOSS, plan)
    assert none is None and loss_only == loss


def test_k10_model_relu_derivative_is_zero_at_zero():
    """A hidden unit at exactly 0 passes no gradient (jax.nn.relu's
    derivative at 0)."""
    w0 = np.zeros((9, 2), f32)
    w0[0, 1] = 1.0
    tree = ((w0, np.zeros((2,), f32)),
            (np.ones((2, 1), f32), np.zeros((1,), f32)))
    params = np.concatenate([np.concatenate([a.ravel(), b.ravel()])
                             for a, b in tree]).astype(f32)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (16, 9)).astype(f32)
    y = np.full((16,), 5.0, f32)
    w = np.ones((16,), f32)
    dims = (9, 2, 1)
    plan = KL.plan_train(16, dims)
    tiled = dataclasses.replace(plan, small=False, threads=64,
                                smem=KL.train_smem(dims, 64), chunks=1)
    for model, p in ((k10_small_model, plan), (k10_model, tiled)):
        _, g = model(params, dims, x, y, w, KL.MODE_GRAD, p)
        gw0 = g[:18].reshape(9, 2)
        assert (gw0[:, 0] == 0).all() and (gw0[:, 1] != 0).any()
