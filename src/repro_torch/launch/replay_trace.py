"""Replay one recorded arrival trace through the DES and the torch engine.

Thin CLI over :mod:`repro_torch.serving.replay` — the DES↔engine
equivalence harness (docs/ENGINE.md documents the methodology and what each
bound means).  Prints a per-scheduler divergence table and optionally
writes the full JSON report.

    PYTHONPATH=src python -m repro_torch.launch.replay_trace --quick \\
        --device cpu --json replay.json
    PYTHONPATH=src python -m repro_torch.launch.replay_trace --full

Without ``--full`` the architecture's smoke config replays ``burst_trace``
in f32.  ``--full`` replays llama2-13b at full width and depth in bf16
(random weights from seed 0, as without it) on the card trace (``card_trace``: 24
requests at t=0, a quarter long) under ``card_engine_config()``, and adds
each scheduler's engine TTFT of short and long requests and its output
rate to the table.

Exits 1 when any scheduler violates its documented bound (exact dispatch
equality for FCFS/SJF; rank correlation >= TAU_BOUND for EWSJF).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..configs import get_config
from ..core.types import Request
from ..serving.replay import burst_trace, replay_ok, run_suite
from .serve import card_engine_config

#: Prompts of at most this many tokens count as short in the card trace.
CARD_SHORT_MAX = 128


def card_trace(n: int = 24, seed: int = 0,
               vocab_size: int = 32000) -> list[Request]:
    """The full-width replay trace: ``n`` requests at t=0, a quarter long
    (700-1900 prompt tokens) and the rest short (16-128), 8-32 new
    tokens."""
    return burst_trace(n=n, seed=seed, vocab_size=vocab_size,
                       short=(16, CARD_SHORT_MAX), long=(700, 1900),
                       long_frac=0.25, out_range=(8, 33))


def ttft_by_class(report: dict, trace: list[Request], side: str = "engine",
                  short_max: int = CARD_SHORT_MAX) -> dict:
    """Mean and p95 TTFT (s) of the short (``prompt_len <= short_max``) and
    long requests of one report, from its ``engine_ttft`` or ``des_ttft``
    table."""
    table = report[f"{side}_ttft"]
    lens = {str(r.request_id): r.prompt_len for r in trace}
    out = {}
    for cls, keep in (("short", lambda n: n <= short_max),
                      ("long", lambda n: n > short_max)):
        v = np.asarray([t for rid, t in table.items() if keep(lens[rid])])
        out[cls] = ({"mean": float(v.mean()),
                     "p95": float(np.percentile(v, 95))}
                    if len(v) else {"mean": float("nan"),
                                    "p95": float("nan")})
    return out


def main() -> int:
    """Parse arguments, run the suite, print the table; 0 when every
    scheduler holds its bound."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None,
                    help="requests in the burst trace (default 12; --full 24)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="llama2-13b",
                    help="smoke-config architecture (dense attention only)")
    ap.add_argument("--schedulers", default="fcfs,sjf,ewsjf",
                    help="comma-separated scheduler registry names")
    ap.add_argument("--quick", action="store_true",
                    help="small trace for CI (n=8)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full divergence report as JSON")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="llama2-13b at full width and depth in bf16 on the "
                         "card trace and card_engine_config()")
    args = ap.parse_args()
    n = 8 if args.quick else (args.n or (24 if args.full else 12))
    schedulers = tuple(args.schedulers.split(","))

    trace = None
    if args.full:
        cfg = get_config("llama2-13b")
        trace = card_trace(n, args.seed, cfg.vocab_size)
        suite = run_suite(seed=args.seed, schedulers=schedulers,
                          arch=cfg.name, ecfg=card_engine_config(), cfg=cfg,
                          trace=trace, device=args.device,
                          dtype=torch.bfloat16)
    else:
        suite = run_suite(n=n, seed=args.seed, arch=args.arch,
                          schedulers=schedulers, device=args.device)
    print(f"replay equivalence: arch={suite['arch']} "
          f"n={suite['n_requests']} seed={suite['seed']}")
    print(f"{'scheduler':>10} {'dispatch':>9} {'tau':>6} "
          f"{'ttft_tau':>8} {'bound':>14} {'ok':>4}")
    for r in suite["reports"]:
        bound = "exact" if r["exact_required"] else f"tau>={r['tau_bound']}"
        ok = replay_ok(r)
        print(f"{r['scheduler']:>10} "
              f"{'match' if r['dispatch_match'] else 'diverge':>9} "
              f"{r['dispatch_tau']:>6.3f} {r['ttft_tau']:>8.3f} "
              f"{bound:>14} {'yes' if ok else 'NO':>4}")
    if trace is not None:
        for r in suite["reports"]:
            eng, des = ttft_by_class(r, trace), ttft_by_class(r, trace, "des")
            print(f"{r['scheduler']:>10} engine TTFT short mean "
                  f"{eng['short']['mean']:.3f} s p95 {eng['short']['p95']:.3f}"
                  f" s, long mean {eng['long']['mean']:.3f} s; "
                  f"{r['engine_tok_per_s']:.1f} tok/s; DES (H100 roofline) "
                  f"mean TTFT short {des['short']['mean']:.4f} s long "
                  f"{des['long']['mean']:.4f} s")
    if args.json:
        Path(args.json).write_text(json.dumps(suite, indent=2))
        print(f"wrote {args.json}")
    return 0 if suite["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
