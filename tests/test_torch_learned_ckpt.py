"""The learned scorer's checkpoints in the port (learn/checkpoint.py, a
copy of the JAX package's) and the LearnedScore manager
(plugins/learned.py), on the CPU.

A checkpoint written by either package loads in the other with equal
arrays and the same fingerprint; the reference's five corrupt payloads
(tests/test_learned.py:130-147) and a NaN file are rejected; the
watcher's cases (a missing file, a transient read failure, keeping the
last good params) behave as the reference's; JAX-written checkpoints of
any width and depth load and serve, and a malformed stack is refused at
load and counted in ``load_errors`` with the last good params kept.
"""

import json
import os

import numpy as np
import pytest
import torch

from kubernetes_tpu.learn import checkpoint as JCK
from kubernetes_tpu.learn.train import identity_params as j_identity
from kubernetes_tpu.learn.train import init_params as j_init
from kubernetes_tpu_torch.kernels import learned as KL
from kubernetes_tpu_torch.learn import checkpoint as TCK
from kubernetes_tpu_torch.learn.train import identity_params as t_identity
from kubernetes_tpu_torch.learn.train import init_params as t_init
from kubernetes_tpu_torch.ops.learned import FEATURE_VERSION, NUM_FEATURES
from kubernetes_tpu_torch.plugins.learned import LearnedScore
from kubernetes_tpu_torch.plugins.registry import in_tree_registry
from tests import torch_port_support  # noqa: F401  (thread cap)

pytestmark = pytest.mark.torch_port


def _np(params):
    return tuple((np.asarray(w, np.float32), np.asarray(b, np.float32))
                 for w, b in params)


def _same(a, b):
    assert len(a) == len(b)
    for (w0, b0), (w1, b1) in zip(a, b):
        assert np.array_equal(np.asarray(w0), np.asarray(w1))
        assert np.array_equal(np.asarray(b0), np.asarray(b1))


@pytest.mark.parametrize("hidden", [(8,), (16, 8)])
def test_jax_checkpoint_loads_in_the_port_and_back(tmp_path, hidden):
    params = j_init(seed=3, hidden=hidden)
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jdoc = JCK.save_checkpoint(jpath, params, meta={"version": 7,
                                                    "created": 1.0})
    loaded, meta = TCK.load_checkpoint(jpath)
    _same(_np(params), loaded)
    assert meta["version"] == 7 and meta["feature_version"] == 3
    assert meta["fingerprint"] == jdoc["meta"]["fingerprint"]
    # the port writes the same document: the JAX package loads it, and
    # the fingerprint (layers + feature version) is the same
    tdoc = TCK.save_checkpoint(tpath, loaded, meta={"version": 7,
                                                    "created": 1.0})
    assert tdoc == jdoc
    back, jmeta = JCK.load_checkpoint(tpath)
    _same(loaded, back)
    assert jmeta["fingerprint"] == jdoc["meta"]["fingerprint"]
    with open(jpath) as f, open(tpath) as g:
        assert json.load(f) == json.load(g)


def test_port_params_round_trip(tmp_path):
    """The port's own init_params (torch tensors) and identity_params
    (numpy) save and load in both packages."""
    for params in (t_init(5, (8,)), t_identity()):
        path = str(tmp_path / "p.json")
        TCK.save_checkpoint(path, params, meta={"version": 1})
        _same(_np(params), TCK.load_checkpoint(path)[0])
        _same(_np(params), JCK.load_checkpoint(path)[0])
    assert TCK.next_version(path) == JCK.next_version(path) == 2
    assert TCK.next_version(str(tmp_path / "none.json")) == 1


@pytest.mark.parametrize("payload", [
    "not json at all {",
    json.dumps({"format_version": 99, "layers": []}),
    json.dumps({"format_version": 1, "feature_version": 99,
                "layers": [{"w": [[1.0]], "b": [0.0]}]}),
    json.dumps({"format_version": 1, "feature_version": FEATURE_VERSION,
                "layers": [{"w": [[1.0] * 3] * NUM_FEATURES,
                            "b": [0.0] * 3}]}),   # head not scalar
    json.dumps({"format_version": 1, "feature_version": FEATURE_VERSION,
                "layers": [{"w": [[1.0]], "b": [0.0]}]}),  # wrong fan-in
], ids=["garbage", "format", "feature", "head", "fanin"])
def test_checkpoint_corrupt_rejected_by_both(tmp_path, payload):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        f.write(payload)
    with pytest.raises(JCK.CheckpointError):
        JCK.load_checkpoint(path)
    with pytest.raises(TCK.CheckpointError):
        TCK.load_checkpoint(path)


def test_nan_checkpoint_file_rejected_at_load(tmp_path):
    """A NaN weight (a diverged training run) never loads, in either
    package: it cannot become the watcher's last good params."""
    path = str(tmp_path / "nan.json")
    w = np.full((NUM_FEATURES, 1), np.nan, np.float32)
    TCK.save_checkpoint(path, ((w, np.zeros((1,), np.float32)),),
                        meta={"version": 13})
    for ck in (JCK, TCK):
        with pytest.raises(ck.CheckpointError, match="non-finite"):
            ck.load_checkpoint(path)
    mgr = LearnedScore({"checkpoint_path": path, "device": "cpu"})
    assert not mgr.maybe_reload()
    assert mgr.params() is None and mgr.stats()["load_errors"] == 1


def test_watcher_missing_file_is_waiting_not_error(tmp_path):
    path = str(tmp_path / "later.json")
    w = TCK.CheckpointWatcher(path)
    assert not w.poll() and not w.poll()
    assert w.load_errors == 0 and w.last_error is None
    TCK.save_checkpoint(path, t_identity(), meta={"version": 1})
    assert w.poll() and w.loads == 1 and w.load_errors == 0


def test_watcher_retries_transient_read_failure(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.json")
    TCK.save_checkpoint(path, t_identity(), meta={"version": 1})
    w = TCK.CheckpointWatcher(path)
    real = TCK.load_checkpoint

    def blip(p):
        raise TCK.CheckpointError("unreadable") from OSError("nfs blip")

    monkeypatch.setattr(TCK, "load_checkpoint", blip)
    assert not w.poll() and w.load_errors == 1 and w.params is None
    monkeypatch.setattr(TCK, "load_checkpoint", real)
    assert w.poll(), "same version retried after the transient failure"
    assert w.meta["version"] == 1


def test_watcher_keeps_last_good_params(tmp_path):
    path = str(tmp_path / "ck.json")
    TCK.save_checkpoint(path, t_identity(), meta={"version": 1})
    w = TCK.CheckpointWatcher(path)
    assert w.poll() and w.params is not None and w.loads == 1
    assert not w.poll(), "unchanged mtime is a no-op"
    good = w.params
    with open(path, "w") as f:
        f.write("corrupt{")
    os.utime(path, (1e9, 1e9))     # force a distinct stamp
    assert not w.poll()
    assert w.load_errors == 1 and w.last_error
    assert w.params is good, "corrupt overwrite keeps the last good stack"
    TCK.save_checkpoint(path, t_identity(), meta={"version": 2})
    assert w.poll() and w.meta["version"] == 2


def test_manager_packs_reloads_and_reports(tmp_path):
    """LearnedScore: waiting while no file exists, one device pack per
    publish (no pack on an unchanged poll), the reference's stats keys,
    a swap counted as a reload."""
    path = str(tmp_path / "scorer.json")
    mgr = LearnedScore({"checkpoint_path": path, "device": "cpu"})
    assert mgr.name() == "LearnedScore"
    assert not mgr.maybe_reload() and mgr.params() is None
    assert mgr.stats()["loaded"] is False and mgr.version == 0
    TCK.save_checkpoint(path, t_init(0, (8,)),
                        meta={"version": 3, "generation": 2})
    assert mgr.maybe_reload()
    first = mgr.params()
    assert isinstance(first, KL.LearnedParams) and first.dims == (9, 8, 1)
    assert first.buf.device.type == "cpu"
    assert not mgr.maybe_reload() and mgr.params() is first
    assert (mgr.version, mgr.generation, mgr.reloads) == (3, 2, 0)
    TCK.save_checkpoint(path, t_init(1, (8,)), meta={"version": 4})
    os.utime(path, (2e9, 2e9))
    assert mgr.maybe_reload() and mgr.reloads == 1 and mgr.version == 4
    _same(_np(t_init(1, (8,))), _np(tuple(
        (w.numpy(), b.numpy()) for w, b in mgr.params().layers)))
    st = mgr.stats()
    for key in ("enabled", "checkpoint_path", "loaded", "version",
                "generation", "fingerprint", "reloads", "loads",
                "load_errors", "last_error", "meta"):
        assert key in st
    assert st["fingerprint"] == mgr.fingerprint and st["loads"] == 2
    # the registry's descriptor builds this manager
    d = in_tree_registry()["LearnedScore"]
    built = d.factory({"checkpoint_path": path, "device": "cpu"})
    assert isinstance(built, LearnedScore) and d.device_score


def _malformed(kind):
    """A stack the JAX package's save_checkpoint writes but no scorer can
    serve: a non-scalar head, or a bias that does not match its W."""
    (w0, b0), (w1, b1) = j_init(seed=5, hidden=(8,))
    if kind == "non_scalar_head":
        return ((w0, b0), (np.concatenate([w1, w1], 1),
                           np.concatenate([b1, b1])))
    return ((w0, np.asarray(b0)[:7]), (w1, b1))


@pytest.mark.parametrize("case", ["w65", "w256x256", "d9", "d12",
                                  "non_scalar_head", "wb_mismatch"])
def test_cap_refusal_counted_and_last_good_kept(tmp_path, case):
    """K9 serves any width and depth (the name is kept from when the port
    refused stacks past a 64-wide, 8-deep cap): a checkpoint the JAX
    package's save_checkpoint writes with a 65-wide layer, (256, 256), or
    9 or 12 layers loads in LearnedScore with no load error, replacing
    the last good params, and its term is within 1e-4 of the JAX
    package's. A malformed stack (a non-scalar head, a W/b mismatch) is
    still refused and counted in load_errors, and the last good params
    keep serving."""
    from kubernetes_tpu.ops import learned as JL
    from kubernetes_tpu_torch.ops import learned as TL

    path = str(tmp_path / "scorer.json")
    TCK.save_checkpoint(path, t_init(0, (8,)), meta={"version": 1})
    mgr = LearnedScore({"checkpoint_path": path, "device": "cpu"})
    assert mgr.maybe_reload()
    good = mgr.params()
    hidden = {"w65": (65,), "w256x256": (256, 256), "d9": (8,) * 8,
              "d12": (8,) * 11}.get(case)
    layers = (j_init(seed=1, hidden=hidden) if hidden is not None
              else _malformed(case))
    JCK.save_checkpoint(path, layers, meta={"version": 2})
    os.utime(path, (3e9, 3e9))
    st = mgr.stats()
    if hidden is None:
        with pytest.raises(JCK.CheckpointError):
            JCK.load_checkpoint(path)      # the JAX package refuses it too
        assert not mgr.maybe_reload()
        st = mgr.stats()
        assert st["load_errors"] == 1 and st["last_error"]
        assert mgr.params() is good and mgr.version == 1
        assert torch.equal(mgr.params().buf, good.buf)
        return
    JCK.load_checkpoint(path)
    assert mgr.maybe_reload()
    st = mgr.stats()
    assert st["load_errors"] == 0 and st["last_error"] is None
    assert mgr.version == 2 and mgr.reloads == 1
    served = mgr.params()
    assert served.dims == (NUM_FEATURES,) + hidden + (1,)
    assert served.n_layers == len(hidden) + 1
    rng = np.random.default_rng(9)
    a = dict(frac=rng.uniform(0, 1, (64, 2)).astype(np.float32),
             **{k: rng.uniform(-20, 140, 64).astype(np.float32) for k in (
                 "fit", "bal", "taint", "aff", "img", "spread", "ipa")})
    want = np.asarray(JL.learned_term(
        layers, **{k: np.asarray(v) for k, v in a.items()}))
    got = TL.learned_term(served.layers,
                          **{k: torch.from_numpy(v) for k, v in a.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
