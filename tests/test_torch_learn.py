"""The learned scorer's training path, the port against the JAX package
on the CPU: the replay dataset and the journal's outcome labels, regret
and the promotion gate, K10's twin against ``jax.value_and_grad``, the
trainer, and the retrain daemon (LearnLoop.run_once) with promotion,
rejection and rollback; then the port's whole closed loop (export ->
loop -> gate -> promote -> hot reload) through its own Scheduler.

The reference's tests/test_learned.py and tests/test_learn_loop.py cases
run here through both packages (``PKGS``) on the same inputs, and their
results are held to each other: exact for the numpy arithmetic (replay,
regret, the gate's verdicts, the loop's reports), 1e-5 relative for
K10's twin against jax.value_and_grad, 1e-4 for a whole train(). The
port draws its initial params from torch.Generator, whose bits are not
jax.random's; where a run trains, the port's ``init_params`` is replaced
by the JAX package's draw (carried across as numpy), so both train from
the same start.
"""

import importlib
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_port_support  # noqa: F401  (thread cap)

pytestmark = pytest.mark.torch_port

JT = importlib.import_module("kubernetes_tpu.learn.train")
TT = importlib.import_module("kubernetes_tpu_torch.learn.train")


def _pkg(root):
    mod = lambda n: importlib.import_module(f"{root}.{n}")  # noqa: E731
    return types.SimpleNamespace(
        name=root, RG=mod("learn.regret"), loop=mod("learn.loop"),
        ck=mod("learn.checkpoint"), replay=mod("learn.replay"),
        train=mod("learn.train"), cli=mod("learn.__main__"))


PKGS = {"jax": _pkg("kubernetes_tpu"), "port": _pkg("kubernetes_tpu_torch")}


@pytest.fixture
def same_init(monkeypatch):
    """The port's trainer starts from the JAX package's init_params."""
    def j_init(seed, hidden=(8,), num_features=9):
        return tuple((np.asarray(w), np.asarray(b))
                     for w, b in JT.init_params(seed, hidden, num_features))
    monkeypatch.setattr(TT, "init_params", j_init)


def _line(t, placements, v=3):
    return json.dumps({"v": v, "cycle": 1, "start": t, "pods": 1,
                       "phases_ms": {}, "placements": placements})


def _row(uid, node, score=100.0, alt=None, feat=None):
    r = {"pod": f"default/{uid}", "uid": uid, "node": node, "score": score}
    if alt is not None:
        r["alt"] = alt
    if feat is not None:
        r["feat"] = feat
    return r


def _write(path, lines, mode="a"):
    with open(path, mode) as f:
        for ln in lines:
            f.write(ln + "\n")


def _feat(hot):
    f = [0.0] * 9
    f[0 if hot else 1] = 1.0
    return f


def _linear_policy(idx, gain=100.0):
    w = np.zeros((9, 1), np.float32)
    w[idx, 0] = gain
    return ((w, np.zeros((1,), np.float32)),)


# ------------------------------------------------------------- replay


def _export_lines():
    rng = np.random.default_rng(4)
    lines = []
    for i in range(40):
        node = f"n{i % 5}" if i % 7 else None
        feat = rng.uniform(0, 1, 9).round(5).tolist() if node else None
        lines.append(_line(float(i // 3), [_row(
            f"u{i % 30}", node, score=float(rng.uniform(10, 90)),
            alt=[[f"n{(i + 1) % 5}", 40.0]] if node else None, feat=feat)],
            v=2 + i % 2))
    lines.append("{torn")
    return lines


def test_replay_dataset_matches_jax(tmp_path):
    from kubernetes_tpu.api.objects import (
        Node, NodeStatus, ObjectMeta, Pod, PodSpec)
    from kubernetes_tpu.utils.wire import to_wire

    path = str(tmp_path / "t.jsonl")
    _write(path, _export_lines())
    wal = str(tmp_path / "wal.jsonl")
    recs = []
    for i in range(5):
        recs.append({"kind": "nodes", "type": "add", "new": to_wire(Node(
            metadata=ObjectMeta(name=f"n{i}", labels={
                "topology.kubernetes.io/zone": f"z{i % 2}"}),
            status=NodeStatus()))})
    for uid, node in (("u3", "n1"), ("u4", ""), ("u8", "n2")):
        recs.append({"kind": "pods", "type": "delete", "old": to_wire(Pod(
            metadata=ObjectMeta(name=uid, uid=uid),
            spec=PodSpec(node_name=node)))})
    _write(wal, [json.dumps(r) for r in recs] + ["{torn"])
    out = {}
    for name, pk in PKGS.items():
        ev, dom = pk.replay.wal_outcomes(wal)
        ds = pk.replay.build_dataset([path], wal_path=wal)
        out[name] = (ev, dom, ds)
    (jev, jdom, jds), (tev, tdom, tds) = out["jax"], out["port"]
    assert jev == tev == {"u3", "u8"} and jdom == tdom
    for f in ("x", "y", "reward", "agg_score"):
        assert np.array_equal(getattr(jds, f), getattr(tds, f)), f
    assert jds.meta == tds.meta
    syn = [pk.replay.synthetic_dataset(3, 64) for pk in PKGS.values()]
    assert np.array_equal(syn[0].x, syn[1].x)
    assert np.array_equal(syn[0].y, syn[1].y)


def test_replay_refuses_exports_without_features(tmp_path):
    path = str(tmp_path / "t.jsonl")
    _write(path, [_line(0.0, [_row("a", "n1")], v=2),
                  _line(0.0, [_row("b", "n1", feat=[0.0] * 9)], v=1)])
    for pk in PKGS.values():
        with pytest.raises(ValueError, match="trace_export_features"):
            pk.replay.build_dataset([path])


# --------------------------------------------------- regret and gate


def _gate_rows():
    rows, node_domain, evicted = [], {}, set()
    for i in range(10):
        uid, node = f"bad{i}", f"h{i}"
        rows.append(dict(_row(uid, node, score=50.0, feat=_feat(True)),
                         t=float(i)))
        node_domain[node] = "hot"
        evicted.add(uid)
    for i in range(30):
        uid, node = f"ok{i}", f"c{i}"
        rows.append(dict(_row(uid, node, score=50.0, feat=_feat(False)),
                         t=float(10 + i)))
        node_domain[node] = f"dom-{i}"
    return rows, evicted, node_domain


def _no_latency(q):
    return {k: v for k, v in q.items() if k != "latency_s"}


def test_regret_and_gate_match_jax():
    rows = [dict(_row("a", "n1", score=90.0, alt=[["n2", 85.0]]), t=1.0),
            dict(_row("b", "n1", score=60.0, alt=[["n2", 80.0]]), t=1.0),
            dict(_row("c", "n1", score=10.0), t=1.0),
            dict(_row("d", "n3", score=90.0,
                      alt=[["n3", 70.0], ["n2", 75.0]]), t=2.0)]
    res = {}
    g_rows, evicted, node_domain = _gate_rows()
    for name, pk in PKGS.items():
        recs = pk.RG.compute_regret(rows, evicted={"a"})
        good, bad = _linear_policy(1), _linear_policy(0)
        v1 = pk.RG.gate_candidate(good, bad, g_rows, evicted, node_domain)
        v2 = pk.RG.gate_candidate(bad, good, g_rows, evicted, node_domain)
        v3 = pk.RG.gate_candidate(good, None, g_rows, evicted, node_domain)
        q = pk.RG.replay_quality(good, g_rows, evicted, node_domain)
        res[name] = (recs, pk.RG.summarize_regret(recs),
                     [{k: v for k, v in v.items()
                       if k not in ("candidate", "live")}
                      for v in (v1, v2, v3)], _no_latency(q))
    assert res["jax"] == res["port"]
    assert res["port"][2][0]["promote"] and not res["port"][2][1]["promote"]


def test_harvest_hub_outcomes_matches_jax():
    """A bound pod's DELETE in the hub's journal is an eviction outcome;
    an unbound pod's is not (the port's hub keeps the pod DELETEs)."""
    from kubernetes_tpu.api.objects import (
        Container, Node, NodeStatus, ObjectMeta, Pod, PodSpec,
        ResourceRequirements)
    from kubernetes_tpu.hub import Hub as JHub
    from kubernetes_tpu_torch.hub import Hub as THub
    from tests.torch_port_support import to_port

    def objects():
        nodes = [Node(metadata=ObjectMeta(name=f"n{i}", labels={
            "topology.kubernetes.io/zone": f"z{i % 2}"}),
            status=NodeStatus(allocatable={"cpu": "4", "pods": "10"}))
            for i in range(3)]
        pods = [Pod(metadata=ObjectMeta(name=f"p{i}", uid=f"p{i}"),
                    spec=PodSpec(containers=[Container(
                        name="c", resources=ResourceRequirements(
                            requests={"cpu": "100m"}))]))
                for i in range(4)]
        return nodes, pods

    out = {}
    for name, hub in (("jax", JHub()), ("port", THub())):
        nodes, pods = objects()
        if name == "port":
            nodes, pods = to_port(nodes), to_port(pods)
        for n in nodes:
            hub.create_node(n)
        for p in pods:
            hub.create_pod(p)
        hub.bind(hub.get_pod("p0"), "n1")
        hub.bind(hub.get_pod("p1"), "n2")
        hub.delete_pod("p0")            # bound: an eviction
        hub.delete_pod("p3")            # never bound: not one
        rg = PKGS[name].RG
        out[name] = rg.harvest_hub_outcomes(hub)
    assert out["jax"] == out["port"]
    assert out["port"][0] == {"p0"}


# ------------------------------------------------------ K10 and train


@pytest.mark.parametrize("hidden", [(8,), (16, 8), (64,), (4, 4, 4)])
@pytest.mark.parametrize("weighted", [False, True])
def test_k10_twin_matches_value_and_grad(hidden, weighted):
    """K10's twin (kernels/learned.py mlp_loss_ref through
    mlp_value_and_grad) against jax.value_and_grad of the reference's
    loss on the same params: loss and every gradient to 1e-5 relative
    (of the loss; of the gradient's largest entry)."""
    from kubernetes_tpu.ops.learned import mlp_apply
    from kubernetes_tpu_torch.kernels import learned as KL

    rng = np.random.default_rng(len(hidden) + 7 * weighted)
    m = 700
    x = rng.uniform(0, 1, (m, 9)).astype(np.float32)
    y = rng.uniform(0, 100, m).astype(np.float32)
    w = (1 + rng.uniform(0, 2, m) if weighted else np.ones(m)) \
        .astype(np.float32)
    params = tuple((np.asarray(a) * np.float32(3.0), np.asarray(b) + 0.1)
                   for a, b in JT.init_params(2, hidden))
    jp = tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in params)
    loss, g = jax.value_and_grad(
        lambda p: jnp.mean(jnp.asarray(w) * (mlp_apply(p, jnp.asarray(x))
                                             - jnp.asarray(y)) ** 2))(jp)
    buf, dims = TT.pack(params, "cpu")
    tl, tg = KL.mlp_value_and_grad(buf, dims, torch.from_numpy(x),
                                   torch.from_numpy(y), torch.from_numpy(w))
    jg = np.concatenate([np.concatenate([np.asarray(a).ravel(),
                                         np.asarray(b).ravel()])
                         for a, b in g])
    assert abs(float(tl) - float(loss)) <= 1e-5 * abs(float(loss))
    assert np.max(np.abs(tg.numpy() - jg)) <= 1e-5 * np.max(np.abs(jg))


def test_k10_twin_relu_derivative_is_zero_at_zero():
    """jax.nn.relu's derivative at 0 is 0: a hidden unit at exactly 0
    passes no gradient, in both."""
    from kubernetes_tpu_torch.kernels import learned as KL

    w0 = np.zeros((9, 2), np.float32)
    w0[0, 1] = 1.0                     # unit 0 is exactly 0 on every row
    params = ((w0, np.zeros((2,), np.float32)),
              (np.ones((2, 1), np.float32), np.zeros((1,), np.float32)))
    buf, dims = TT.pack(params, "cpu")
    x = torch.rand((16, 9))
    _, g = KL.mlp_value_and_grad(buf, dims, x, torch.full((16,), 5.0),
                                 torch.ones(16))
    gw0 = g[:18].view(9, 2)
    assert bool((gw0[:, 0] == 0).all()) and bool((gw0[:, 1] != 0).any())


@pytest.mark.parametrize("hidden,bc,ft", [((8,), 40, 20), ((16, 8), 25, 0)])
def test_train_matches_jax(same_init, hidden, bc, ft):
    """A whole train() at small epochs: the params and the loss record
    of the reference's to 1e-4."""
    jds = PKGS["jax"].replay.synthetic_dataset(1, 300)
    tds = PKGS["port"].replay.ReplayDataset(x=jds.x, y=jds.y,
                                            reward=jds.reward)
    cfg = dict(hidden=hidden, seed=2, bc_epochs=bc, ft_epochs=ft)
    jparams, jinfo = JT.train(jds, JT.TrainConfig(**cfg))
    tparams, tinfo = TT.train(tds, TT.TrainConfig(**cfg), device="cpu")
    assert set(jinfo) == set(tinfo)
    for k, v in jinfo.items():
        if isinstance(v, float):
            assert abs(tinfo[k] - v) <= 1e-4 * max(1.0, abs(v)), k
        else:
            assert tinfo[k] == v, k
    for (a, b), (c, d) in zip(jparams, tparams):
        np.testing.assert_allclose(c, np.asarray(a), rtol=0, atol=1e-4)
        np.testing.assert_allclose(d, np.asarray(b), rtol=0, atol=1e-4)


def test_train_is_deterministic_and_learns():
    """The reference's test_smoke_train_is_deterministic_and_learns on the
    port: the same seed and dataset give bit-identical params, and the
    behavior-cloning loss falls."""
    ds = PKGS["port"].replay.synthetic_dataset(0, 256)
    cfg = TT.TrainConfig(bc_epochs=60, ft_epochs=20)
    p1, i1 = TT.train(ds, cfg, device="cpu")
    p2, _ = TT.train(ds, cfg, device="cpu")
    for (a, b), (c, d) in zip(p1, p2):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    assert i1["bc_loss_last"] < i1["bc_loss_first"]


# ---------------------------------------------------------- the loop


def _loop_cfg(pk, tmp_path, **kw):
    kw.setdefault("trace_path", str(tmp_path / "traces.jsonl"))
    kw.setdefault("staging_dir", str(tmp_path / "staging"))
    kw.setdefault("live_path", str(tmp_path / "live.json"))
    kw.setdefault("min_new_rows", 8)
    kw.setdefault("min_holdout_rows", 2)
    kw.setdefault("bc_epochs", 30)
    kw.setdefault("ft_epochs", 10)
    if pk.name == "kubernetes_tpu_torch":
        kw.setdefault("device", "cpu")
    return pk.loop.LoopConfig(**kw)


def _trainable(n, start=0.0):
    return [_line(start + i, [_row(
        f"u{i}", f"n{i % 4}", score=50.0 + i,
        alt=[[f"n{(i + 1) % 4}", 45.0 + i]], feat=_feat(i % 2 == 0))])
        for i in range(n)]


def _report(rep):
    keep = ("status", "generation", "version", "new_rows", "new_trainable",
            "pending", "buffer", "examples", "train_regret")
    out = {k: rep[k] for k in keep if k in rep}
    if "gate" in rep:
        out["gate"] = rep["gate"]
    if "rollback" in rep:
        out["rollback"] = {k: rep["rollback"][k] for k in rep["rollback"]
                           if k not in ("at",)}
    return out


def _scenario_waits(pk, tmp_path):
    cfg = _loop_cfg(pk, tmp_path)
    _write(cfg.trace_path, _trainable(3))
    reps = [pk.loop.LearnLoop(cfg).run_once()]
    reps.append(pk.loop.LearnLoop(_loop_cfg(pk, tmp_path)).run_once())
    _write(cfg.trace_path, _trainable(21, start=50.0))
    reps.append(pk.loop.LearnLoop(_loop_cfg(pk, tmp_path)).run_once())
    assert reps[0]["status"] == "waiting" and reps[1]["pending"] == 3
    return [_report(r) for r in reps], None


def _scenario_bootstrap(pk, tmp_path):
    cfg = _loop_cfg(pk, tmp_path)
    _write(cfg.trace_path, _trainable(24))
    loop = pk.loop.LearnLoop(cfg)
    rep = loop.run_once()
    assert rep["status"] == "promoted" and rep["gate"]["bootstrap"]
    params, meta = pk.ck.load_checkpoint(cfg.live_path)
    assert meta["generation"] == 1 and meta["promoted"] is True
    _write(cfg.trace_path, _trainable(24, start=100.0))
    rep2 = loop.run_once()
    assert rep2["generation"] == 2 and rep2["version"] == 2
    return [_report(rep), _report(rep2)], params


def _scenario_rejection(pk, tmp_path, monkeypatch):
    cfg = _loop_cfg(pk, tmp_path)
    _write(cfg.trace_path, _trainable(24))
    loop = pk.loop.LearnLoop(cfg)
    assert loop.run_once()["status"] == "promoted"
    live_before = open(cfg.live_path).read()

    def refuse(cand, live, rows, *a, **kw):
        return {"promote": False, "bootstrap": False, "wins": [],
                "losses": ["preemptions", "spread"], "latency_ok": True}

    monkeypatch.setattr(pk.RG, "gate_candidate", refuse)
    _write(cfg.trace_path, _trainable(24, start=100.0))
    rep = loop.run_once()
    assert rep["status"] == "rejected"
    assert loop.metrics.rejected.value() == 1.0
    assert open(cfg.live_path).read() == live_before
    assert os.path.exists(os.path.join(cfg.staging_dir, "scorer-g2.json"))
    return [_report(rep)], None


def _scenario_rollback(pk, tmp_path):
    cfg = _loop_cfg(pk, tmp_path, min_rollback_rows=4)
    loop = pk.loop.LearnLoop(cfg)
    pk.ck.save_checkpoint(os.path.join(cfg.staging_dir, "last-good.json"),
                          _linear_policy(1),
                          meta={"version": 1, "generation": 1,
                                "promoted": True})
    pk.ck.save_checkpoint(cfg.live_path, _linear_policy(0),
                          meta={"version": 2, "generation": 2,
                                "promoted": True})
    loop.state.update(generation=2, version=2, promoted={
        "generation": 2, "version": 2, "regret_mean": 0.0, "at": 0.0})
    loop._save_state()
    _write(cfg.trace_path, [_line(200.0 + i, [_row(
        f"r{i}", "n1", score=10.0, alt=[["n2", 90.0]])]) for i in range(2)])
    rep0 = loop.run_once()
    _write(cfg.trace_path, [_line(210.0 + i, [_row(
        f"s{i}", "n1", score=10.0, alt=[["n2", 90.0]])]) for i in range(3)])
    rep = loop.run_once()
    assert "rollback" not in rep0 and "rollback" in rep
    _, meta = pk.ck.load_checkpoint(cfg.live_path)
    assert meta["rolled_back_from"] == 2 and meta["version"] == 3
    return [_report(rep0), _report(rep)], None


@pytest.mark.parametrize("scenario", ["waits", "bootstrap", "rejection",
                                      "rollback"])
def test_learn_loop_matches_jax(scenario, tmp_path, monkeypatch, same_init):
    """tests/test_learn_loop.py's daemon scenarios through both packages'
    LearnLoop.run_once on the same export: the same reports (status,
    generation, version, row counts, the gate's verdict, the rollback)
    and, where the loop trains, the same promoted params to 1e-4."""
    out = {}
    for name, pk in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        if scenario == "rejection":
            out[name] = _scenario_rejection(pk, d, monkeypatch)
        else:
            out[name] = globals()[f"_scenario_{scenario}"](pk, d)
    (jr, jp), (tr, tp) = out["jax"], out["port"]
    assert jr == tr
    if jp is not None:
        for (a, b), (c, d) in zip(jp, tp):
            np.testing.assert_allclose(c, a, rtol=0, atol=1e-4)
            np.testing.assert_allclose(d, b, rtol=0, atol=1e-4)


def test_cli_train_autobump_and_loop_once(tmp_path, capsys, same_init):
    """The port's CLI on the CPU: train --synthetic auto-bumps the
    version like the reference's; loop --once --device cpu promotes."""
    main = PKGS["port"].cli.main
    out = str(tmp_path / "ck.json")
    args = ["train", "--synthetic", "64", "--out", out, "--bc-epochs", "20",
            "--ft-epochs", "5", "--device", "cpu"]
    assert main(args) == 0
    assert json.loads(capsys.readouterr().out)["meta"]["version"] == 1
    assert main(args) == 0
    assert json.loads(capsys.readouterr().out)["meta"]["version"] == 2
    traces = str(tmp_path / "traces.jsonl")
    _write(traces, _trainable(24))
    assert main(["loop", "--traces", traces, "--staging",
                 str(tmp_path / "st"), "--live", str(tmp_path / "live.json"),
                 "--once", "--min-rows", "8", "--bc-epochs", "20",
                 "--ft-epochs", "5", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["status"] == "promoted"


def test_port_closed_loop_one_cycle(tmp_path):
    """tests/test_learn_loop.py::test_one_cycle_closed_loop_smoke on the
    port: its Scheduler exports v3 rows with features and alternatives,
    its LearnLoop (device cpu: K10's twin) retrains and promotes, and the
    running Scheduler hot-reloads the promoted generation."""
    from kubernetes_tpu_torch.api.objects import (
        LABEL_HOSTNAME, Container, Node, NodeStatus, ObjectMeta, Pod,
        PodSpec, ResourceRequirements)
    from kubernetes_tpu_torch.config.types import Plugin, default_config
    from kubernetes_tpu_torch.hub import Hub
    from kubernetes_tpu_torch.ops.features import Capacities
    from kubernetes_tpu_torch.scheduler import Scheduler

    def node(i):
        return Node(metadata=ObjectMeta(name=f"node-{i}", labels={
            LABEL_HOSTNAME: f"node-{i}"}), status=NodeStatus(allocatable={
                "cpu": "8", "memory": "16Gi", "pods": "110"}))

    def pod(name):
        return Pod(metadata=ObjectMeta(name=name), spec=PodSpec(
            containers=[Container(name="c", resources=ResourceRequirements(
                requests={"cpu": "100m"}))]))

    export = str(tmp_path / "traces.jsonl")
    live = str(tmp_path / "live.json")
    cfg = default_config()
    cfg.batch_size = 16
    cfg.trace_export_path = export
    cfg.trace_export_features = True
    cfg.trace_export_alts = True
    prof = cfg.profiles[0]
    prof.plugins.score.enabled.append(Plugin("LearnedScore", 1.0))
    prof.plugin_config["LearnedScore"] = {"checkpoint_path": live}
    hub = Hub()
    sched = Scheduler(hub, cfg, caps=Capacities(nodes=16, pods=64),
                      device="cpu")
    try:
        mgr = sched._profile_cfg["default-scheduler"]["learned"]
        for i in range(4):
            hub.create_node(node(i))
        for i in range(12):
            hub.create_pod(pod(f"p{i}"))
        sched.run_until_idle()
        assert mgr.params() is None
        rows = [r for ln in (json.loads(x) for x in open(export)
                             if x.strip())
                for r in ln.get("placements", [])]
        placed = [r for r in rows if r["node"]]
        assert placed and all("alt" in r and "feat" in r for r in placed)
        assert any(any(nm != r["node"] for nm, _s in r["alt"])
                   for r in placed)
        loop = PKGS["port"].loop.LearnLoop(PKGS["port"].loop.LoopConfig(
            trace_path=export, staging_dir=str(tmp_path / "staging"),
            live_path=live, min_new_rows=8, min_holdout_rows=2,
            bc_epochs=30, ft_epochs=10, device="cpu"))
        rep = loop.run_once()
        assert rep["status"] == "promoted", rep
        os.utime(live, (2e9, 2e9))
        for i in range(4):
            hub.create_pod(pod(f"q{i}"))
        sched.run_until_idle()
        assert mgr.params() is not None
        assert mgr.version == rep["version"]
        assert mgr.generation == rep["generation"] == 1
        assert sched.metrics.learned_magnitude.count() >= 1
        assert all(p.spec.node_name for p in hub.list_pods())
    finally:
        sched.close()


def test_ab_scorer_smoke_with_generations():
    """The port's A/B harness at smoke size on the CPU: the collection,
    the training, both arms of the three workloads with their regret
    columns, and two refresh generations through the retrain daemon."""
    from kubernetes_tpu_torch.perf.ab_scorer import run_ab_scorer

    res = run_ab_scorer(smoke=True, generations=3, device="cpu")
    assert set(res["workloads"]) == {"SchedulingBasic", "TopologySpreading",
                                     "PreemptionAsync"}
    for row in res["workloads"].values():
        for arm in ("hand", "learned"):
            assert "regret_mean" in row[arm]["quality"]
    assert [g["generation"] for g in res["generations"]] == [1, 2]
    assert all(g["status"] in ("promoted", "rejected")
               for g in res["generations"])
