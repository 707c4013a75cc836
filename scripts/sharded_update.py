#!/usr/bin/env python3
"""Times AdamW's in-place update of a sharded LM's parameters two ways,
on the DTensors and on each rank's local shards (what ``train_step``
does, ``Optimizer.elementwise``), and checks that both give the same
parameters and state bit for bit; needs one CUDA card.  Where the update
on the DTensors raises (PyTorch 2.11 cannot flatten a head-sharded leaf
into the flat slices the update runs on), it says so and times the local
shards alone.

    python3 scripts/sharded_update.py [--reps 7]

llama3.2-3b at full width, 4 bf16 layers, placed as ``chip_smoke.py``'s
phase 19 places them: 2 ``gloo-host`` ranks sharing the card on a (1, 2)
``(data, model)`` mesh.  The update moves no data between ranks either
way, so the host staging of ``gloo-host`` does not enter the times.
Prints each rank's median wall of each way (alternated, card synchronised
around each) beside the card's name and power limit.  Imports nothing of
JAX.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def update_rank(rank, device, spec, reps):
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.sharding import shard_ctx
    from repro_torch.launch.group import lm_setup
    from repro_torch.launch.mesh import AbstractMesh, device_mesh
    from repro_torch.models.convert import distribute_params
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.train.optimizer import get_optimizer
    cfg, model, params, _ = lm_setup(spec, device)
    mesh = AbstractMesh(tuple(spec["mesh"]), ("data", "model"))
    dm = device_mesh(mesh, device)
    opt = get_optimizer(cfg)
    assert opt.name == "adamw", opt.name
    state = opt.init(params)
    params = distribute_params(params, model, cfg, dm)
    sdecls = opt.state_decls(model.decls)
    state = {k: v if k == "count" else
             distribute_params(v, model, cfg, dm, sdecls[k])
             for k, v in state.items()}
    grads = [p.detach().clone().mul_(1e-3) for p in leaves(params)]
    lr = cfg.learning_rate

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def dtensors():
        opt.update_(list(grads), state, params, lr)

    def shards():
        local = {k: v if k == "count" else tree_map(lambda t: t.to_local(), v)
                 for k, v in state.items()}
        opt.update_([g.to_local() for g in grads], local,
                    tree_map(lambda t: t.to_local(), params), lr)
        state["count"] = local["count"]

    def snapshot():
        return [t.to_local().clone() for t in leaves(params)
                + leaves(state["m"]) + leaves(state["v"])]

    def restore(snap, count):
        for t, s in zip(leaves(params) + leaves(state["m"])
                        + leaves(state["v"]), snap):
            t.to_local().copy_(s)
        state["count"] = count
    with shard_ctx(cfg, mesh, dm):
        first, count = snapshot(), state["count"]
        ways, error, equal = {"dtensors": dtensors, "shards": shards}, None, None
        try:
            dtensors()
        except RuntimeError as e:
            error = f"{type(e).__name__}: {str(e)[:300]}"
            del ways["dtensors"]
        if error is None:
            by_dtensor = snapshot()
            restore(first, count)
            shards()
            equal = all(torch.equal(a, b)
                        for a, b in zip(by_dtensor, snapshot()))
            del by_dtensor
        del first
        walls = {name: [] for name in ways}
        for _ in range(reps):
            for name, fn in ways.items():
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                walls[name].append(time.perf_counter() - t0)
    dist.barrier()
    return {"equal": equal, "error": error, "walls": walls,
            "leaves": len(leaves(params))}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("[fail] no CUDA device", file=sys.stderr)
        return 1
    import statistics

    import chip_smoke as cs
    from repro_torch.launch.group import spawn_partitions
    stamp = cs.card_stamp()
    print(f"[card] {stamp}; torch {torch.__version__}", flush=True)
    spec = {k: v for k, v in cs.SHARDED_LM.items() if k != "steps"}
    ranks = spawn_partitions(update_rank, 2, "gloo-host",
                             ["cuda:0", "cuda:0"], args=(spec, args.reps),
                             timeout=cs.GROUP_JOIN_S)
    bad = [r for r, got in enumerate(ranks) if got["equal"] is False]
    for r, got in enumerate(ranks):
        med = {k: f"{statistics.median(v) * 1e3:.2f}"
               for k, v in got["walls"].items()}
        every = {k: [round(w * 1e3, 2) for w in v]
                 for k, v in got["walls"].items()}
        dt = (f"the update on the DTensors raises ({got['error']})"
              if got["error"] else f"bit-equal {got['equal']}")
        print(f"[update] rank {r}: AdamW over {got['leaves']} leaves, median "
              f"of {args.reps} (ms) {med}; every wall {every}; {dt}  "
              f"[{stamp}]", flush=True)
    if bad:
        print(f"[fail] ranks {bad}: the two updates differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
