"""The learned score term of the port (ops/learned.py, the twin of kernel
K9; kernels/learned.py, its packed parameters and paths; learn/train.py's
parameter half) against the JAX package's ops/learned.py and
learn/train.py, on the CPU, and kernels/build.py's library names.

Inputs are made from a numpy seed and fed to both packages. The feature
rows are exact (a true division by 100 in both). The MLP is held to
1e-4 absolute: XLA's dot on the CPU may reorder or contract the
products, the port sums left to right as K9 does (the kernel is held to
this twin bit for bit on the card, chip_smoke.py). A NaN in the params
must reach the output in both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.learn.train import identity_params as j_identity
from kubernetes_tpu.learn.train import init_params as j_init
from kubernetes_tpu.ops import learned as JL
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.kernels import build as KB
from kubernetes_tpu_torch.kernels import learned as KL
from kubernetes_tpu_torch.learn.checkpoint import CheckpointError
from kubernetes_tpu_torch.learn.train import identity_params as t_identity
from kubernetes_tpu_torch.learn.train import init_params as t_init
from kubernetes_tpu_torch.ops import learned as TL
from tests import torch_port_support  # noqa: F401  (thread cap)

pytestmark = pytest.mark.torch_port

TOL = 1e-4
# the served scorers, and past what the port once capped: a 65-wide
# layer, (256, 256), 9 and 12 layers deep
WIDTHS = {"identity": None, "h8": (8,), "h16_8": (16, 8), "h64": (64,),
          "h65": (65,), "h256_256": (256, 256), "d9": (8,) * 8,
          "d12": (16,) * 11}


def _inputs(seed, n=257):
    """Per-node arrays on their pipeline scales, with some scores past
    the 0-100 range (the clip's edges)."""
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa
    return dict(frac=rng.uniform(0, 1, (n, 2)).astype(np.float32),
                fit=f(0, 100), bal=f(0, 100), taint=f(0, 100),
                aff=f(0, 100), img=f(0, 100), spread=f(-20, 140),
                ipa=f(0, 100))


def _jax(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


def _port(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _params(width, seed=0):
    """The JAX package's params as numpy (identity, or its init_params,
    with non-zero biases so they are exercised too)."""
    if width is None:
        return tuple((np.asarray(w), np.asarray(b))
                     for w, b in j_identity())
    rng = np.random.default_rng(seed + 100)
    return tuple((np.asarray(w), rng.normal(0, 0.5, np.asarray(b).shape)
                  .astype(np.float32))
                 for w, b in j_init(seed=seed, hidden=width))


def test_constants_match():
    assert TL.LEARNED_FEATURES == JL.LEARNED_FEATURES
    assert TL.NUM_FEATURES == JL.NUM_FEATURES == 9
    assert TL.FEATURE_VERSION == JL.FEATURE_VERSION == 3
    assert TL.MAX_SCORE == JL.MAX_SCORE


@pytest.mark.parametrize("topo", [False, True], ids=["no_topo", "topo"])
@pytest.mark.parametrize("seed", [0, 1])
def test_feature_rows_and_row_at_exact(seed, topo):
    a = _inputs(seed)
    if not topo:
        a.pop("spread")
        a.pop("ipa")
    want = np.asarray(JL.feature_rows(**_jax(a)))
    got = TL.feature_rows(**_port(a)).numpy()
    assert got.shape == (257, TL.NUM_FEATURES)
    assert np.array_equal(want, got)
    for row in (0, 7, 256):
        w_row = np.asarray(JL.feature_row_at(row, **_jax(a)))
        g_row = TL.feature_row_at(row, **_port(a)).numpy()
        assert np.array_equal(w_row, g_row)


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("seed", [0, 3])
def test_mlp_and_learned_term_match_jax(width, seed):
    params = _params(WIDTHS[width], seed)
    a = _inputs(seed)
    feats = np.asarray(JL.feature_rows(**_jax(a)))
    jp = tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in params)
    tp = convert.learned_params(params, "cpu")
    raw_j = np.asarray(JL.mlp_apply(jp, jnp.asarray(feats)))
    raw_t = TL.mlp_apply(tp.layers, torch.tensor(feats)).numpy()
    np.testing.assert_allclose(raw_t, raw_j, rtol=0, atol=TOL)
    term_j = np.asarray(JL.learned_term(jp, **_jax(a)))
    term_t = TL.learned_term(tp.layers, **_port(a)).numpy()
    np.testing.assert_allclose(term_t, term_j, rtol=0, atol=TOL)
    assert term_t.min() >= 0.0 and term_t.max() <= 100.0
    # the probe's twin is the same function over raw rows
    rows = np.concatenate([a["frac"]] + [a[k][:, None] for k in (
        "fit", "bal", "taint", "aff", "img", "spread", "ipa")], axis=1)
    probe = KL.learned_probe(tp, torch.from_numpy(rows)).numpy()
    assert np.array_equal(probe, term_t)


def test_learned_term_hits_both_clip_edges():
    """A head that scales the features far past [0, 100] both ways: the
    clip holds in both packages and they agree."""
    w = np.zeros((TL.NUM_FEATURES, 1), np.float32)
    w[2, 0], w[3, 0] = 400.0, -300.0
    params = ((w, np.zeros((1,), np.float32)),)
    a = _inputs(5)
    term_j = np.asarray(JL.learned_term(
        tuple((jnp.asarray(x), jnp.asarray(y)) for x, y in params),
        **_jax(a)))
    term_t = TL.learned_term(convert.learned_params(params, "cpu").layers,
                             **_port(a)).numpy()
    np.testing.assert_allclose(term_t, term_j, rtol=0, atol=TOL)
    assert (term_t == 0.0).any() and (term_t == 100.0).any()


@pytest.mark.parametrize("where", ["w0", "b0", "w_last"])
def test_nan_params_propagate(where):
    """A NaN weight or bias reaches every output it feeds, through the
    ReLU and the clip, in both packages (so the launch guard sees it)."""
    params = [list(p) for p in _params((8,), 2)]
    if where == "w0":
        params[0][0] = params[0][0].copy()
        params[0][0][3, :] = np.nan
    elif where == "b0":
        params[0][1] = params[0][1].copy()
        params[0][1][:] = np.nan
    else:
        params[1][0] = params[1][0].copy()
        params[1][0][0, 0] = np.nan
    params = tuple(tuple(p) for p in params)
    a = _inputs(4)
    term_j = np.asarray(JL.learned_term(
        tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in params),
        **_jax(a)))
    term_t = TL.learned_term(convert.learned_params(params, "cpu").layers,
                             **_port(a)).numpy()
    assert np.isnan(term_j).all() and np.isnan(term_t).all()


def test_relu_and_clip_pass_nan():
    x = torch.tensor([float("nan"), -1.0, 0.5, 150.0])
    r, c = TL.relu(x), TL.clip_score(x)
    assert torch.isnan(r[0]) and torch.isnan(c[0])
    assert r[1:].tolist() == [0.0, 0.5, 150.0]
    assert c[1:].tolist() == [0.0, 0.5, 100.0]


def test_hand_weight_vector_and_identity_params_match():
    assert np.array_equal(TL.hand_weight_vector(), JL.hand_weight_vector())
    (wj, bj), = j_identity()
    (wt, bt), = t_identity()
    assert np.array_equal(np.asarray(wj), wt)
    assert np.array_equal(np.asarray(bj), bt)


@pytest.mark.parametrize("hidden", [(8,), (16, 8), (64,) * 7])
def test_init_params_shapes_and_seed(hidden):
    """He init from a torch.Generator: the reference's shapes, zero
    biases, the same stack for the same seed, another for another."""
    a, b = t_init(0, hidden), t_init(0, hidden)
    c = t_init(1, hidden)
    ref = j_init(0, hidden)
    assert [tuple(w.shape) for w, _ in a] == [
        tuple(np.asarray(w).shape) for w, _ in ref]
    for (w0, b0), (w1, b1), (w2, _) in zip(a, b, c):
        assert w0.dtype == torch.float32 and torch.equal(w0, w1)
        assert torch.equal(b0, torch.zeros_like(b0)) and torch.equal(b0, b1)
        assert not torch.equal(w0, w2)
    KL.check_caps(a)


def test_packed_params_views_and_caps():
    params = _params((16, 8), 1)
    lp = convert.learned_params(params, "cpu")
    assert lp.dims == (9, 16, 8, 1) and lp.n_layers == 3
    assert lp.buf.is_contiguous() and lp.buf.numel() == sum(
        w.size + b.size for w, b in params)
    assert lp.dims_buf.dtype == torch.int32
    assert lp.dims_buf.tolist() == [9, 16, 8, 1]
    for (w, b), (vw, vb) in zip(params, lp.layers):
        assert np.array_equal(w, vw.numpy()) and np.array_equal(b, vb.numpy())
    net = KL.net_of(lp, 16)
    assert net.n_layers == 3 and net.n_params == lp.buf.numel()
    assert net.dims == lp.dims_buf.data_ptr() and net.narrow == 16
    assert KL.smem_floats(net, 16) % 4 == 0
    assert KL.net_of(None, 16).n_layers == 0
    # any width and depth packs; only a malformed stack is refused
    for hidden in ((65,), (256, 256), (8,) * 8, (8,) * 11, (1024,)):
        KL.check_caps(t_init(0, hidden))
    bad_head = t_init(0, (8,))[:1]
    with pytest.raises(CheckpointError, match="head must be scalar"):
        KL.check_caps(bad_head)
    (w0, b0), last = t_init(0, (8,))
    with pytest.raises(CheckpointError, match="layer 0"):
        convert.learned_params(((w0, b0[:7]), last), "cpu")
    assert not hasattr(KL, "LearnedCapError")


@pytest.mark.parametrize("hidden,narrow,pairs,shared", [
    ((), 8, 0, 0), ((8,), 8, 0, 0), ((16, 8), 16, 0, 0), ((20,), 24, 0, 0),
    ((32,) * 16, 32, 0, 0), ((33,), 0, 8, 1), ((65,), 0, 4, 1),
    ((256, 256), 0, 2, 1), ((1024,), 0, 8, 0)])
def test_net_of_picks_the_path(hidden, narrow, pairs, shared):
    """csrc/learned_mlp.cuh's two paths, for a kernel of 16 warps: the
    narrow width class (the widest hidden layer rounded up to 8), or the
    wide path's pairs a warp and where its slabs live (shared memory while
    a block's slabs fit 64 KB, else a global scratch); the shared floats
    K9 takes and the scratch the wrapper attaches."""
    lp = KL.LearnedParams.pack(t_init(0, hidden), "cpu")
    net = KL.net_of(lp, 16)
    assert (net.narrow, net.pairs, net.slab_shared) == (narrow, pairs, shared)
    assert net.widest % 4 == 0 and net.widest >= max(lp.dims)
    lf = KL.smem_floats(net, 16)
    if narrow:
        assert net.n_staged == KL.staged_floats(lp.dims) >= lp.buf.numel()
        assert net.n_staged % 4 == 0 and net.n_staged <= KL.NARROW_FLOATS
        assert lf == net.n_staged + ((len(lp.dims) + 3) & ~3)
    elif shared:
        assert lf == 16 * 2 * pairs * net.widest
        assert lf * 4 <= KL.SLAB_SHARED_MAX
    else:
        assert lf == 0
    scratch = KL.scratch_for(net, 40, "cpu")
    if narrow or shared:
        assert scratch is None and not net.scratch
    else:
        assert scratch.numel() == 40 * KL.slab_floats(net)
        assert net.scratch == scratch.data_ptr()


def test_k2a_narrow_classes_stop_at_16():
    """K2a instantiates the narrow classes 8 and 16 only (64 registers a
    thread): a 24-wide scorer takes the wide path there, the narrow one in
    K3 and the probe."""
    lp = KL.LearnedParams.pack(t_init(0, (24,)), "cpu")
    assert KL.net_of(lp, 16).narrow == 24
    k2a = KL.net_of(lp, 16, 16)
    assert k2a.narrow == 0 and k2a.pairs >= 1
    assert KL.net_of(KL.LearnedParams.pack(t_init(0, (16, 8)), "cpu"), 16,
                     16).narrow == 16


def test_library_name_hashes_local_headers(tmp_path):
    """kernels/build.py names a library by its source, the local headers
    it includes (recursively) and the flags: an edited header gives a new
    name, so a stale K2a or K3 library is never loaded."""
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#define W 64\n")
    first = KB.source_digest(str(src))
    assert KB.source_digest(str(src)) == first
    (tmp_path / "b.cuh").write_text("#define W 128\n")
    second = KB.source_digest(str(src))
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n// edited\n')
    third = KB.source_digest(str(src))
    assert len({first, second, third}) == 3
    assert KB.source_digest(str(src), flags=("-O2",)) != third
    # the shipped sources: K2a and K3 name the K9 header
    for name in ("auction_score_argmax", "serial_scan", "learned_mlp"):
        with open(os.path.join(KB.SRC_DIR, name + ".cu")) as f:
            assert '#include "learned_mlp.cuh"' in f.read()
    assert "learned_mlp" in KB.KERNELS and "learned_mlp" in KB.LAUNCHES
