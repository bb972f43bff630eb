"""Learned-scorer CLI: ``python -m kubernetes_tpu_torch.learn <cmd>``
(port of the JAX package's learn/__main__.py). ``train`` and ``loop``
run on the card (kernel K10) unless given ``--device cpu``.

    train     build a replay dataset from trace exports (+ optional WAL)
              — or --synthetic N — and train a checkpoint
    loop      the retrain daemon (learn/loop.py): tail the rotating
              trace export, retrain on a cadence, gate candidates
              against the live checkpoint on held-out rows, promote
              winners to the path the scheduler hot-reloads (--once
              runs one iteration and prints the report)
    identity  write the identity-init checkpoint (reproduces the
              hand-tuned aggregate; the differential-test fixture)
    inspect   print a checkpoint's meta + shape chain
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kubernetes-tpu-torch-learn")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train", help="train a scorer checkpoint")
    p_train.add_argument("--traces", nargs="*", default=[],
                         help="flight-recorder JSON-lines export files "
                              "(scheduler --trace-export)")
    p_train.add_argument("--wal", default=None,
                         help="hub journal WAL for outcome labels")
    p_train.add_argument("--synthetic", type=int, default=0,
                         help="train on N synthetic examples instead of "
                              "trace exports (smoke/CI)")
    p_train.add_argument("--out", required=True, help="checkpoint path")
    p_train.add_argument("--seed", type=int, default=0)
    p_train.add_argument("--hidden", type=int, nargs="*", default=[8])
    p_train.add_argument("--bc-epochs", type=int, default=300)
    p_train.add_argument("--ft-epochs", type=int, default=150)
    p_train.add_argument("--device", default="cuda",
                         help="cuda (kernel K10, the default) or cpu")
    p_train.add_argument("--version", type=int, default=None,
                         help="checkpoint version stamp (monotonic per "
                              "deployment; surfaced by the "
                              "scheduler_learned_checkpoint_version "
                              "gauge). Default: one past the version "
                              "already at --out, so a forgotten flag "
                              "never walks the gauge backwards")

    p_loop = sub.add_parser(
        "loop", help="retrain daemon: tail exports, retrain, gate, "
                     "promote (learn/loop.py)")
    p_loop.add_argument("--traces", required=True,
                        help="the scheduler's ROTATING trace export "
                             "path (the .1 rotation sibling is tailed "
                             "automatically)")
    p_loop.add_argument("--wal", default=None,
                        help="hub journal WAL for outcome labels")
    p_loop.add_argument("--staging", required=True,
                        help="staging dir: candidates, last-good, "
                             "cursor/loop state")
    p_loop.add_argument("--live", required=True,
                        help="the LIVE checkpoint path the scheduler's "
                             "CheckpointWatcher polls — only gated "
                             "winners land here")
    p_loop.add_argument("--once", action="store_true",
                        help="run one loop body and exit (the "
                             "one-command closed-loop proof)")
    p_loop.add_argument("--interval", type=float, default=300.0)
    p_loop.add_argument("--min-rows", type=int, default=64)
    p_loop.add_argument("--seed", type=int, default=0)
    p_loop.add_argument("--hidden", type=int, nargs="*", default=[8])
    p_loop.add_argument("--bc-epochs", type=int, default=120)
    p_loop.add_argument("--ft-epochs", type=int, default=60)
    p_loop.add_argument("--device", default="cuda",
                        help="cuda (kernel K10, the default) or cpu")

    p_id = sub.add_parser("identity", help="identity-init checkpoint")
    p_id.add_argument("--out", required=True)
    # version 0 is the checkpoint-version gauge's "none loaded"
    # sentinel; a deployed identity checkpoint must read as loaded
    p_id.add_argument("--version", type=int, default=1)

    p_ins = sub.add_parser("inspect", help="print checkpoint meta")
    p_ins.add_argument("path")

    args = parser.parse_args(argv)

    from kubernetes_tpu_torch.learn import checkpoint as ck

    if args.cmd == "inspect":
        params, meta = ck.load_checkpoint(args.path)
        print(json.dumps({
            "meta": meta,
            "layers": [{"w": list(w.shape), "b": list(b.shape)}
                       for w, b in params],
        }, indent=2, default=str))
        return 0

    if args.cmd == "identity":
        from kubernetes_tpu_torch.learn.train import identity_params

        doc = ck.save_checkpoint(args.out, identity_params(),
                                 meta={"identity": True,
                                       "version": args.version})
        print(json.dumps({"written": args.out, "meta": doc["meta"]}))
        return 0

    if args.cmd == "loop":
        from kubernetes_tpu_torch.learn.loop import LearnLoop, LoopConfig

        loop = LearnLoop(LoopConfig(
            trace_path=args.traces, wal_path=args.wal,
            staging_dir=args.staging, live_path=args.live,
            interval_s=args.interval, min_new_rows=args.min_rows,
            seed=args.seed, hidden=tuple(args.hidden),
            bc_epochs=args.bc_epochs, ft_epochs=args.ft_epochs,
            device=args.device))
        if args.once:
            report = loop.run_once()
            print(json.dumps(report, default=str))
            return 0
        loop.run_forever()
        return 0

    # train
    from kubernetes_tpu_torch.learn.replay import build_dataset, synthetic_dataset
    from kubernetes_tpu_torch.learn.train import TrainConfig, train

    if args.synthetic:
        ds = synthetic_dataset(seed=args.seed, n=args.synthetic)
    elif args.traces:
        ds = build_dataset(args.traces, wal_path=args.wal)
    else:
        print("train needs --traces or --synthetic", file=sys.stderr)
        return 2
    # auto-bump: an unset --version continues the existing checkpoint's
    # sequence instead of republishing version 1 over it
    version = (args.version if args.version is not None
               else ck.next_version(args.out))
    cfg = TrainConfig(hidden=tuple(args.hidden), seed=args.seed,
                      bc_epochs=args.bc_epochs, ft_epochs=args.ft_epochs,
                      meta={"version": version, **ds.meta})
    params, info = train(ds, cfg, device=args.device)
    doc = ck.save_checkpoint(args.out, params, meta=info)
    print(json.dumps({"written": args.out, "meta": doc["meta"]},
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
