"""Continuous-batching serve driver on the paged-KV engine (torch).

Admits an open-loop Poisson arrival stream into
`repro_torch.serve.engine`: request slots come from a labeled-GUID array,
the KV cache is pages of one shared §6-partitioned block, and cold
sessions spill to disk through the IO queue when ``--resident-budget`` is
set.  The model runs on ``--device`` (the card by default).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --requests 16 --rate 200 [--smoke] [--device cpu] [--static]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.serve.engine import (ModelBackend, ServeEngine, SyntheticBackend,
                                      poisson_workload, run_static)


def _fmt(m: dict) -> str:
    return (f"{m['tokens']:.0f} toks in {m['makespan_s'] * 1e3:.1f}ms virtual "
            f"-> {m['tok_per_s']:.0f} tok/s, "
            f"p50 {m['p50_latency_s'] * 1e3:.2f}ms "
            f"p99 {m['p99_latency_s'] * 1e3:.2f}ms")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (tiny dims, fp32)")
    ap.add_argument("--synthetic", action="store_true",
                    help="skip the model; deterministic token function")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate, requests per virtual second")
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(8, 24),
                    metavar=("LO", "HI"))
    ap.add_argument("--gen", type=int, nargs=2, default=(4, 12),
                    metavar=("LO", "HI"))
    ap.add_argument("--b-cap", type=int, default=8,
                    help="request slots / decode batch rows")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page")
    ap.add_argument("--pool-pages", type=int, default=64)
    ap.add_argument("--max-pages", type=int, default=8,
                    help="page-table width (max pages per request)")
    ap.add_argument("--resident-budget", type=int, default=0,
                    help="data blocks resident per node before session "
                         "archives spill to disk (0 = unlimited)")
    ap.add_argument("--static", action="store_true",
                    help="also run the static-batch baseline")
    ap.add_argument("--monitor", action="store_true",
                    help="print live monitoring-registry snapshots "
                         "(queue depth, inflight IO, pages, sessions) "
                         "at --monitor-every virtual-second intervals")
    ap.add_argument("--monitor-every", type=float, default=0.01,
                    metavar="S", help="snapshot interval, virtual seconds")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _print_snap(t: float, snap: dict) -> None:
    print(f"  [monitor t={t * 1e3:8.3f}ms] "
          f"queued {snap['serve.queued']:.0f} "
          f"active {snap['serve.active']:.0f} "
          f"free_pages {snap['serve.free_pages']:.0f} "
          f"io_inflight {snap.get('io.inflight_ops', 0):.0f} "
          f"io_depth {snap.get('io.queue_depth', 0):.0f} "
          f"spilled {snap.get('spill.objects', 0):.0f}")


def build(args: argparse.Namespace):
    """The workload and the engine the CLI runs: (engine, requests).
    Weights are random, drawn from a ``torch.Generator`` seeded with
    ``--seed`` on the model's device."""
    reqs = poisson_workload(args.requests, args.rate,
                            prompt_len=tuple(args.prompt_len),
                            gen=tuple(args.gen), seed=args.seed)
    if args.synthetic:
        backend = SyntheticBackend(args.page_size)
    else:
        from repro_torch.models.model import LanguageModel
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)
        model = LanguageModel(cfg, device=args.device)
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        params = model.init(gen)
        pad = args.page_size
        prompt_pad = ((args.prompt_len[1] + pad - 1) // pad) * pad
        backend = ModelBackend(model, params, pool_pages=args.pool_pages,
                               page_size=args.page_size,
                               prompt_pad=prompt_pad)
        for r in reqs:
            r.prompt = np.minimum(r.prompt, cfg.vocab_size - 1)

    eng = ServeEngine(backend, b_cap=args.b_cap,
                      pool_pages=args.pool_pages, max_pages=args.max_pages,
                      resident_budget=args.resident_budget or None,
                      monitor=args.monitor or None,
                      monitor_interval=args.monitor_every if args.monitor
                      else 0.0,
                      on_monitor=_print_snap if args.monitor else None)
    return eng, reqs


def main(argv=None) -> None:
    args = parse_args(argv)
    eng, reqs = build(args)
    t0 = time.perf_counter()
    m = eng.run(reqs)
    wall = time.perf_counter() - t0
    print(f"continuous: {_fmt(m)}  "
          f"[evictions {m['evictions']:.0f}, resumes {m['resumes']:.0f}, "
          f"spilled {m['spilled_objects']:.0f}; wall {wall:.2f}s]")
    if args.monitor:
        print(f"monitor: {len(eng.monitor_snapshots)} snapshots; "
              f"hist p99 latency {m['p99_hist_latency_s'] * 1e3:.2f}ms, "
              f"hist p99 ttft {m['p99_hist_ttft_s'] * 1e3:.2f}ms")
    for r in reqs[: min(2, len(reqs))]:
        print(f"  req{r.rid}: {r.out}")

    if args.static:
        s = run_static(reqs, b_cap=args.b_cap)
        print(f"static:     {_fmt(s)}")
        print(f"speedup: {m['tok_per_s'] / s['tok_per_s']:.2f}x tok/s, "
              f"{s['p99_latency_s'] / max(m['p99_latency_s'], 1e-12):.2f}x p99")


if __name__ == "__main__":
    main()
