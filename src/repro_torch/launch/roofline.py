"""Roofline analysis from the port's dry-run files, ported from the JAX
package's ``launch/roofline.py``.

Per (arch × shape) on one mesh, from ``launch/dryrun.py``'s per-rank counts
(``launch/op_count.py``):

    compute term    = FLOPs_per_rank            / H100_PEAK_FLOPS_BF16
    memory term     = traffic_bytes_per_rank    / H100_HBM_BW
    collective term = collective_bytes_per_rank / H100_NVLINK_BW

The figures are the H100 SXM data sheet's (``core/cost_model.py``): 989
TFLOP/s dense bf16, 3.35 TB/s HBM3, and 450 GB/s, one direction of NVLink
4.  NVLink 4 is the figure within one node of 8 cards; a 256- or 512-card
mesh crosses nodes over a slower network, so on these meshes the
collective term is a lower bound.  The dominant term is the step-time
lower bound; "MFU@bound" is the fraction of peak a card would reach at
that bound doing only the MODEL_FLOPS-useful work:

    MFU@bound = (MODEL_FLOPS / chips / peak) / max(terms)

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline [--variant base]
        [--mesh pod_16x16] [--json] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..core.cost_model import H100_HBM_BW, H100_NVLINK_BW, H100_PEAK_FLOPS_BF16
from .dryrun import OUT_DIR

PEAK = H100_PEAK_FLOPS_BF16
HBM = H100_HBM_BW
LINK = H100_NVLINK_BW


def _remark(row: dict) -> str:
    kind = row["desc"]["kind"]
    dom = row["dominant"]
    if dom == "collective":
        return ("overlap/shrink collectives: reduce-scatter grads, "
                "fuse all-gathers with matmuls, EP a2a instead of gathers")
    if dom == "memory":
        if kind == "decode":
            return ("decode is weight/KV streaming-bound: grow batch, "
                    "quantize KV, MLA-style latent cache")
        return ("cut HBM traffic: fuse element-wise passes, fewer remat "
                "passes, bf16 stash")
    if kind == "train":
        return "raise matmul efficiency: bigger per-card tiles, less remat"
    return "compute-bound: kernel quality (flash tiles), skip masked blocks"


def load_cells(variant: str = "base", mesh: str = "pod_16x16",
               out_dir: Path = OUT_DIR) -> list[dict]:
    return [json.loads(fn.read_text())
            for fn in sorted(Path(out_dir).glob(f"*__{mesh}__{variant}.json"))]


def step_terms(counts: dict) -> dict:
    """(compute, memory, collective) seconds of per-rank counts."""
    return {"compute": counts["flops"] / PEAK,
            "memory": counts["traffic_bytes"] / HBM,
            "collective": counts["collective_bytes"] / LINK}


def roofline_terms(row: dict) -> dict | None:
    if row.get("status") != "ok" or "counts" not in row:
        return None
    terms = step_terms(row["counts"])
    dom = max(terms, key=terms.get)
    chips = row["chips"]
    bound = max(terms.values())
    model_t = row["model_flops"] / chips / PEAK
    out = dict(row)
    out.update({
        "t_compute": terms["compute"], "t_memory": terms["memory"],
        "t_collective": terms["collective"], "dominant": dom,
        "bound_s": bound,
        "mfu_at_bound": model_t / bound if bound > 0 else 0.0,
        "useful_flops_ratio": row["model_flops"] / max(
            row["counts"]["flops"] * chips, 1),
    })
    out["remark"] = _remark(out)
    return out


def fmt_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | compute (ms) | memory (ms) | collective (ms) | "
           "dominant | MFU@bound | useful/counted | HBM GB/card |\n"
           "|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        if r.get("status") == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skipped: {r['reason'][:40]} | — | — | — |")
            continue
        t = roofline_terms(r)
        if t is None:
            lines.append(f"| {r['arch']} | {r['shape']} | ? | ? | ? | "
                         f"{r.get('status')} | ? | ? | ? |")
            continue
        mem_gb = r["memory"]["argument_bytes"] / 1e9
        lines.append(
            f"| {t['arch']} | {t['shape']} | {t['t_compute']*1e3:.1f} "
            f"| {t['t_memory']*1e3:.1f} | {t['t_collective']*1e3:.1f} "
            f"| **{t['dominant']}** | {t['mfu_at_bound']*100:.1f}% "
            f"| {t['useful_flops_ratio']*100:.0f}% | {mem_gb:.1f} |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="base")
    ap.add_argument("--mesh", default="pod_16x16")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", type=Path, default=OUT_DIR,
                    help=f"directory of the dry run's rows (default {OUT_DIR})")
    args = ap.parse_args()
    rows = load_cells(args.variant, args.mesh, args.out)
    if args.json:
        print(json.dumps([roofline_terms(r) or r for r in rows], indent=1,
                         default=str))
        return
    print(fmt_table(rows))


if __name__ == "__main__":
    main()
