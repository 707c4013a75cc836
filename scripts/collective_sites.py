"""Where the sharded LM step's collectives come from, by call site.

Traces one train step of the port on ``meta`` DTensors over a fake group
(``launch/dryrun.count_collectives`` with ``sites``) and tallies every
collective by op and by the port's innermost frame that issued it.  The
bytes DTensor's step moves differ between PyTorch versions; tracing on
each and comparing the two tallies names the redistributions that differ.

    PYTHONPATH=src python scripts/collective_sites.py --out a.json
    PYTHONPATH=src python scripts/collective_sites.py --compare a.json b.json

The default step is that of ``chip_smoke.py``'s phase 19: llama3.2-3b at
full width, 4 bf16 layers, a batch of 2 x 1024 tokens on a (1, 2)
(data, model) mesh.  ``--cell ARCH SHAPE single|multi`` traces a dry-run
cell instead (its config on the (16, 16) or (2, 16, 16) production mesh):
the sites of its first depth probe, and both probes' bytes extrapolated
to full depth as ``launch.dryrun`` does.  ``--src DIR`` imports the port
from another checkout's ``src`` (say the parent commit unpacked by ``git
archive``), so one script traces both versions:

    PYTHONPATH=src python scripts/collective_sites.py \
        --cell mamba2-1.3b train_4k single --src _archive/parent/src

Needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def tally(sites: list) -> dict:
    """{"op @ site": [calls, bytes]} of a trace's sites (the innermost
    frame of the port that issued each collective)."""
    out = defaultdict(lambda: [0, 0])
    for s in sites:
        key = f"{s['op']} {s['dtype']}{s['shape']} @ " + \
            (s["at"][-1] if s["at"] else "?")
        out[key][0] += 1
        out[key][1] += s["bytes"]
    return dict(out)


def trace(args) -> dict:
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.group import lm_config
    from repro_torch.launch.mesh import AbstractMesh
    cfg = lm_config({"arch": args.arch, "num_layers": args.layers,
                     "dtype": args.dtype})
    mesh = AbstractMesh(tuple(args.mesh), ("data", "model"))
    got = dryrun.count_collectives(
        cfg, ShapeConfig("sites", "train", args.seq, args.batch), mesh,
        sites=True)
    return {"torch": torch.__version__, "arch": args.arch,
            "layers": args.layers, "dtype": args.dtype,
            "batch": args.batch, "seq": args.seq, "mesh": args.mesh,
            "per_op": got["per_op"], "counts": got["counts"],
            "total": got["total"], "seconds": got["seconds"],
            "tally": tally(got["sites"])}


def trace_cell(args) -> dict:
    import torch

    from repro_torch.configs import SHAPES_BY_NAME, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    arch, shape, kind = args.cell
    mesh = make_production_mesh(multi_pod=kind == "multi")
    (c1, u1), (c2, u2), uf = dryrun.depth_probe_cfgs(get_config(arch))
    with dryrun.CollectiveTracer() as tracer:
        tracer.timeout = args.timeout
        p1 = tracer.count(c1, SHAPES_BY_NAME[shape], mesh, True)
        p2 = tracer.count(c2, SHAPES_BY_NAME[shape], mesh)
    ops = sorted(set(p1["per_op"]) | set(p2["per_op"]))
    full = {op: dryrun._extrapolate(p1["per_op"].get(op, 0),
                                    p2["per_op"].get(op, 0), u1, u2, uf)
            for op in ops}
    return {"torch": torch.__version__, "cell": args.cell,
            "mesh": list(mesh.sizes), "per_op": p1["per_op"],
            "counts": p1["counts"], "total": p1["total"],
            "seconds": p1["seconds"], "probe2_per_op": p2["per_op"],
            "probe2_seconds": p2["seconds"], "full_per_op": full,
            "full_total": sum(full.values()), "tally": tally(p1["sites"])}


def compare(a: dict, b: dict) -> None:
    print(f"A torch {a['torch']}: {a['total']} B {a['counts']}")
    print(f"B torch {b['torch']}: {b['total']} B {b['counts']}")
    for key in sorted(set(a["tally"]) | set(b["tally"])):
        ca, ba = a["tally"].get(key, [0, 0])
        cb, bb = b["tally"].get(key, [0, 0])
        if (ca, ba) != (cb, bb):
            print(f"  {key}: A {ca} calls {ba} B, B {cb} calls {bb} B "
                  f"(B - A {bb - ba} B)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--mesh", type=int, nargs=2, default=[1, 2])
    ap.add_argument("--out", default=None, help="write the trace as JSON")
    ap.add_argument("--compare", nargs=2, default=None, metavar="JSON",
                    help="print the sites where two written traces differ")
    ap.add_argument("--cell", nargs=3, default=None,
                    metavar=("ARCH", "SHAPE", "MESH"),
                    help="a dry-run cell on the single or multi production "
                         "mesh: its first depth probe's sites and both "
                         "probes extrapolated to full depth")
    ap.add_argument("--src", default=str(SRC),
                    help="the checkout's src to import the port from")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a trace may take")
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(Path(p).read_text()) for p in args.compare)
        compare(a, b)
        return 0
    sys.path.insert(0, str(Path(args.src).resolve()))
    res = trace_cell(args) if args.cell else trace(args)
    print(f"torch {res['torch']}: {res['total']} B a device, "
          f"{res['per_op']}, {res['counts']} calls, {res['seconds']:.1f} s")
    if args.cell:
        print(f"second probe {res['probe2_per_op']} in "
              f"{res['probe2_seconds']:.1f} s; full depth "
              f"{res['full_total']:.0f} B a device, {res['full_per_op']}")
    for key, (n, nbytes) in sorted(res["tally"].items()):
        print(f"  {key}: {n} calls, {nbytes} B")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
