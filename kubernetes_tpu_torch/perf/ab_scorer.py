"""The learned-scoring A/B harness (the port's copy of the JAX package's
``bench.py --ab-scorer``, ``run_ab_scorer`` / ``_ab_scorer_run``).

End to end in one process: (1) a hand-tuned SchedulingBasic collection
run with the v3 trace export on (features and alternatives), (2) the
scorer trained from the exported placement rows (learn/train.py; kernel
K10 on the card), (3) paired runs of the hand-tuned and the learned
profile on SchedulingBasic, TopologySpreading and PreemptionAsync with
the same tie-break seed, each arm's phase total (the Scheduler's
``stats["time_s"]``) and quality columns (preemptions, and the regret
mean / p99 of perf/harness.py regret_columns). ``generations`` N closes
the loop N - 1 more times: each generation collects under the live
learned policy, and the retrain daemon's body (learn/loop.py) retrains,
gates and publishes the checkpoint the next run hot-reloads.

Differences from the reference's: the latency reading is the port's
phase totals (the flight recorder's profile rows are not ported); the
quality columns are preemptions and regret (the spread and time-to-bind
columns need the reference's pod timelines, a later slice).

    python -m kubernetes_tpu_torch.perf.ab_scorer [--smoke]
        [--generations N] [--scale S] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

# learned-vs-hand phase-total parity bar on SchedulingBasic
AB_LATENCY_BUDGET = 0.03
TIE_SEED = 2026_0801


def run_ab_scorer(smoke: bool = False, scale: float = 0.1,
                  generations: int = 1, device="cuda") -> dict:
    """The A/B artifact row (see the module docstring); the work
    directory (exports, checkpoints) is removed on every exit path."""
    workdir = tempfile.mkdtemp(prefix="ab_scorer_")
    try:
        return _ab_scorer_run(workdir, smoke, scale, generations, device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _ab_scorer_run(workdir: str, smoke: bool, scale: float,
                   generations: int, device) -> dict:
    from kubernetes_tpu_torch.config.types import Plugin, default_config
    from kubernetes_tpu_torch.learn.checkpoint import save_checkpoint
    from kubernetes_tpu_torch.learn.replay import build_dataset
    from kubernetes_tpu_torch.learn.train import TrainConfig, train
    from kubernetes_tpu_torch.perf import workloads as W
    from kubernetes_tpu_torch.perf.harness import run_workload

    def shrink(factory, **kw):
        """Smoke variant: a small cluster and small capacity buckets."""
        def make():
            w = factory(**kw)
            w.node_capacity = 64
            w.pod_capacity = 2048
            w.batch_size = 32
            w.warm_full_nodes = False
            return w
        return make

    if smoke:
        scale = 1.0
        ab_factories = (
            ("SchedulingBasic", shrink(W.scheduling_basic, init_nodes=32,
                                       init_pods=16, measure_pods=200)),
            ("TopologySpreading", shrink(W.topology_spreading,
                                         init_nodes=32, init_pods=64,
                                         measure_pods=96)),
            ("PreemptionAsync", shrink(W.preemption_async, init_nodes=24,
                                       init_pods=80, measure_pods=48)),
        )
        collection = ab_factories[0][1]
    else:
        ab_factories = (("SchedulingBasic", W.scheduling_basic),
                        ("TopologySpreading", W.topology_spreading),
                        ("PreemptionAsync", W.preemption_async))
        collection = W.scheduling_basic

    def base_cfg():
        c = default_config()
        c.tie_break_seed = TIE_SEED
        return c

    def export_into(c, path):
        c.trace_export_path = path
        c.trace_export_features = True
        c.trace_export_alts = True
        c.trace_export_max_bytes = 0
        return c

    trace_path = os.path.join(workdir, "traces.jsonl")
    ckpt_path = os.path.join(workdir, "scorer.json")
    print("ab-scorer: collection run (trace export)...", file=sys.stderr)
    run_workload(collection(), scale=scale,
                 config=export_into(base_cfg(), trace_path), device=device)
    ds = build_dataset([trace_path])
    params, info = train(ds, TrainConfig(
        seed=0, meta={"version": 1, "source": "ab_scorer"}), device=device)
    doc = save_checkpoint(ckpt_path, params, meta=info)
    print(f"ab-scorer: trained on {len(ds)} examples (bc loss "
          f"{info['bc_loss_first']} -> {info['bc_loss_last']})",
          file=sys.stderr)

    def learned_cfg():
        c = base_cfg()
        prof = c.profiles[0]
        prof.plugins.score.enabled.append(Plugin("LearnedScore", 1.0))
        prof.plugin_config["LearnedScore"] = {"checkpoint_path": ckpt_path}
        return c

    def arm(res: dict) -> dict:
        q = dict(res.get("quality", {}))
        q["preemptions"] = int(res["stats"].get("preemptions", 0))
        return {"pods_per_sec": res.get("pods_per_sec"),
                "phase_total_s": round(sum(res["stats"]["time_s"].values()),
                                       4),
                "quality": q}

    out, improved_any = {}, []
    for name, factory in ab_factories:
        pair = {}
        for arm_name, cfg_fn in (("hand", base_cfg),
                                 ("learned", learned_cfg)):
            pair[arm_name] = run_workload(
                factory(), scale=scale, device=device,
                config=export_into(cfg_fn(), os.path.join(
                    workdir, f"ab_{name}_{arm_name}.jsonl")))
        hand, learned = arm(pair["hand"]), arm(pair["learned"])
        ht, lt = hand["phase_total_s"], learned["phase_total_s"]
        delta = (lt - ht) / ht if ht > 0 else 0.0
        qd, better = {}, []
        for k in ("preemptions", "regret_mean", "regret_p99"):
            if k not in hand["quality"] or k not in learned["quality"]:
                continue            # no data on one side: never a win
            hv, lv = hand["quality"][k], learned["quality"][k]
            qd[k] = round(lv - hv, 3)
            if hv > 0 and lv < hv and (hv - lv) >= 0.01 * hv:
                better.append(k)
        if better:
            improved_any.append(name)
        out[name] = {"hand": hand, "learned": learned,
                     "latency_delta_pct": round(delta * 100.0, 2),
                     "quality_delta": qd, "improved": better}
        print(f"ab-scorer {name}: phase-total {ht:.3f}s -> {lt:.3f}s "
              f"({delta * 100:+.2f}%), improved: {better or 'none'}",
              file=sys.stderr)
    gens = []
    if generations > 1:
        from kubernetes_tpu_torch.learn.loop import LearnLoop, LoopConfig

        loop_traces = os.path.join(workdir, "loop_traces.jsonl")
        loop = LearnLoop(LoopConfig(
            trace_path=loop_traces,
            staging_dir=os.path.join(workdir, "staging"),
            live_path=ckpt_path, min_new_rows=32, min_holdout_rows=8,
            bc_epochs=80 if smoke else 200,
            ft_epochs=40 if smoke else 100, device=str(device)))
        for _g in range(2, generations + 1):
            res = run_workload(collection(), scale=scale, device=device,
                               config=export_into(learned_cfg(),
                                                  loop_traces))
            rep = loop.run_once()
            gens.append({"generation": rep.get("generation"),
                         "version": rep.get("version"),
                         "status": rep.get("status"),
                         "gate": rep.get("gate"),
                         "regret": rep.get("regret"),
                         "pods_per_sec": res.get("pods_per_sec"),
                         "quality": res.get("quality")})
            print(f"ab-scorer generation {rep.get('generation')}: "
                  f"{rep.get('status')} (version {rep.get('version')})",
                  file=sys.stderr)
    basic = out.get("SchedulingBasic", {})
    budget = AB_LATENCY_BUDGET if not smoke else 0.15
    result = {
        "metric": "ab_scorer", "unit": "quality", "smoke": smoke,
        "tie_break_seed": TIE_SEED, "scale": scale, "device": str(device),
        "checkpoint": {k: doc["meta"].get(k)
                       for k in ("version", "fingerprint", "examples",
                                 "bc_loss_last")},
        "latency_budget_pct": budget * 100.0,
        "latency_ok": basic.get("latency_delta_pct", 0.0) <= budget * 100.0,
        "improved_workloads": improved_any,
        "workloads": out,
    }
    if gens:
        result["generations"] = gens
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubernetes-tpu-torch-ab-scorer")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--generations", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run_ab_scorer(args.smoke, args.scale, args.generations,
                                   args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
