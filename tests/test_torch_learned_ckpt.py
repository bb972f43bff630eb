"""The learned scorer's checkpoints in the port (learn/checkpoint.py, a
copy of the JAX package's) and the LearnedScore manager
(plugins/learned.py), on the CPU.

A checkpoint written by either package loads in the other with equal
arrays and the same fingerprint; the reference's five corrupt payloads
(tests/test_learned.py:130-147) and a NaN file are rejected; the
watcher's cases (a missing file, a transient read failure, keeping the
last good params) behave as the reference's; and the port's one stated
deviation, the hand kernel's width and depth caps, is refused at load
and counted in ``load_errors`` with the last good params kept.
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


def test_cap_refusal_counted_and_last_good_kept(tmp_path):
    """A stated deviation: a checkpoint wider than the hand kernel holds
    (a 65-wide layer; the JAX package would serve it) is refused at load,
    counted in load_errors with a message naming the cap, and the last
    good params keep serving, as for a corrupt file."""
    path = str(tmp_path / "scorer.json")
    TCK.save_checkpoint(path, t_init(0, (64,) * 7), meta={"version": 1})
    mgr = LearnedScore({"checkpoint_path": path, "device": "cpu"})
    assert mgr.maybe_reload()
    good = mgr.params()
    assert good.dims == (9,) + (64,) * 7 + (1,)
    wide = j_init(seed=1, hidden=(65,))
    JCK.save_checkpoint(path, wide, meta={"version": 2})
    os.utime(path, (3e9, 3e9))
    JCK.load_checkpoint(path)          # the JAX package loads it
    assert not mgr.maybe_reload()
    st = mgr.stats()
    assert st["load_errors"] == 1 and "MAX_WIDTH = 64" in st["last_error"]
    assert mgr.params() is good and mgr.version == 1
    deep = t_init(0, (8,) * 8)
    TCK.save_checkpoint(path, deep, meta={"version": 3})
    os.utime(path, (4e9, 4e9))
    assert not mgr.maybe_reload()
    assert mgr.stats()["load_errors"] == 2
    assert "MAX_LAYERS = 8" in mgr.stats()["last_error"]
    assert mgr.params() is good
    assert torch.equal(mgr.params().buf, good.buf)
