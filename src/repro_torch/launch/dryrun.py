"""Multi-pod dry run of the port: every (arch × shape × mesh) cell run on
meta tensors in one process that stands for all 256 or 512 ranks, ported
from the JAX package's ``launch/dryrun.py``.

Where JAX lowers and compiles each cell for 512 forced host devices and
reads XLA's cost and memory analyses, the port builds the cell
(``launch/cells.py``) under a fake world (``launch/mesh.py::
init_fake_world``: collectives return at once and move nothing), runs its
step once on meta DTensors under ``distributed.spmd.spmd``, and counts rank
0's FLOPs, bytes and collectives as it runs (``launch/op_count.py``).
Every rank of these meshes holds shards of one shape, so rank 0 stands for
all.  Each row also records ``model_flops`` (6·N_active·tokens for
training, 2·N_active·tokens otherwise, as JAX does), ``n_params``,
``n_params_active`` and the bytes of the rank's parameter, optimizer-state
and argument shards.

``--all`` runs each cell in a subprocess of its own, as JAX does: one
process holds one default process group, so a fake world never shares a
process with another.  Rows go to ``launch_out/dryrun_torch/`` (never JAX's
``launch_out/dryrun``); ``python -m repro_torch.launch.roofline`` reads
them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape decode_32k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[3] / "launch_out" / "dryrun_torch"


def mesh_name(multi_pod: bool) -> str:
    return "multipod_2x16x16" if multi_pod else "pod_16x16"


def count_cell(cell) -> dict:
    """Run ``cell``'s step once under a counter; returns the counter's
    summary."""
    from ..distributed.spmd import spmd
    from .op_count import OpCounter
    with OpCounter() as counter, spmd():
        cell.step_fn(*cell.args)
    return counter.summary()


def _arg_tensors(cell) -> list:
    import torch
    from torch.utils._pytree import tree_flatten
    flat = []
    for a in cell.args:
        if isinstance(a, torch.nn.Module):
            flat.extend(a.parameters())
        elif hasattr(a, "_asdict"):                     # AdamWState
            flat.extend(tree_flatten((a.m, a.v))[0])
        else:
            flat.extend(tree_flatten(a)[0])
    return [t for t in flat if isinstance(t, torch.Tensor)]


def run_cell(arch: str, shape: str, multi_pod: bool, moe_impl: str,
             variant: str = "base") -> dict:
    """Build and count one production cell in this process (which must
    not hold a default process group yet)."""
    from ..configs import get_config
    from .cells import build_cell, skip_reason
    from .mesh import init_fake_world, make_production_mesh, production_shape
    from .op_count import local_bytes

    cfg = get_config(arch)
    row = {"arch": arch, "shape": shape, "mesh": mesh_name(multi_pod),
           "variant": variant, "moe_impl": moe_impl}
    reason = skip_reason(cfg, shape)
    if reason:
        row["status"] = "skipped"
        row["reason"] = reason
        return row
    t0 = time.time()
    dims, _ = production_shape(multi_pod)
    world = 1
    for d in dims:
        world *= d
    init_fake_world(world)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    cell = build_cell(arch, shape, mesh, moe_impl=moe_impl)
    t_build = time.time() - t0
    counts = count_cell(cell)
    row.update(status="ok", build_s=round(t_build, 2),
               run_s=round(time.time() - t0 - t_build, 2),
               desc=cell.static_desc, chips=world, counts=counts)
    params = cell.args[0]
    row["memory"] = {
        "param_bytes": local_bytes(params.parameters()),
        "opt_state_bytes": (local_bytes(list(cell.args[1].m.values())
                                        + list(cell.args[1].v.values()))
                            if cell.static_desc["kind"] == "train" else 0),
        "argument_bytes": local_bytes(_arg_tensors(cell)),
    }
    n_active = cfg.active_param_count()
    d = cell.static_desc
    tokens = d["batch"] * (d["seq"] if d["kind"] != "decode" else 1)
    mult = 6.0 if d["kind"] == "train" else 2.0
    row["model_flops"] = mult * n_active * tokens
    row["n_params"] = cfg.param_count()
    row["n_params_active"] = n_active
    return row


def cell_filename(arch: str, shape: str, mesh: str, variant: str,
                  out_dir: Path = OUT_DIR) -> Path:
    return Path(out_dir) / f"{arch}__{shape}__{mesh}__{variant}.json"


def main() -> None:
    ap = argparse.ArgumentParser(description="Multi-pod dry run (port)")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--moe-impl", default="dropping",
                    choices=["dense", "dropping", "ep_a2a"])
    ap.add_argument("--variant", default="base")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch×shape×mesh) cell via subprocesses")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--out", type=Path, default=OUT_DIR,
                    help=f"directory of the rows (default {OUT_DIR})")
    args = ap.parse_args()

    args.out.mkdir(parents=True, exist_ok=True)

    if args.all:
        from .cells import ARCHS, SHAPES
        jobs = [(a, s, mp) for a in ARCHS for s in SHAPES
                for mp in (False, True)]
        done = failed = 0
        t0 = time.time()
        for arch, shape, mp in jobs:
            fn = cell_filename(arch, shape, mesh_name(mp), args.variant,
                               args.out)
            if fn.exists() and not args.force:
                done += 1
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape,
                   "--moe-impl", args.moe_impl, "--variant", args.variant,
                   "--out", str(args.out)]
            if mp:
                cmd.append("--multi-pod")
            print(f"[dryrun] {arch} × {shape} × {mesh_name(mp)} ...",
                  flush=True)
            try:
                r = subprocess.run(cmd, timeout=args.timeout,
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    failed += 1
                    fn.write_text(json.dumps({
                        "arch": arch, "shape": shape, "mesh": mesh_name(mp),
                        "variant": args.variant, "status": "error",
                        "error": r.stderr[-4000:]}, indent=1))
                    last = r.stderr.strip().splitlines()
                    print(f"  FAILED: {last[-1] if last else '?'}")
                else:
                    done += 1
            except subprocess.TimeoutExpired:
                failed += 1
                fn.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mesh_name(mp),
                    "variant": args.variant, "status": "timeout"}, indent=1))
                print("  TIMEOUT")
        print(f"[dryrun] complete: {done} ok or skipped, {failed} failed, "
              f"{time.time() - t0:.0f} s")
        sys.exit(1 if failed else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    row = run_cell(args.arch, args.shape, args.multi_pod, args.moe_impl,
                   args.variant)
    fn = cell_filename(args.arch, args.shape, row["mesh"], args.variant,
                       args.out)
    fn.write_text(json.dumps(row, indent=1))
    print(json.dumps(row, indent=1))


if __name__ == "__main__":
    main()
