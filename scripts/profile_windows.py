#!/usr/bin/env python3
"""Whether ``torch.profiler`` records the flash backward's kernels in the
windows ``chip_smoke.py`` phase 14 (a) takes, outside that script.

  python3 scripts/profile_windows.py       (one CUDA card; from the root)

Builds the kernels, then profiles five calls of ``flash_attention_bwd`` at
the llama3.2-3b prefill shape ``(2, 4096, 24, 8, 128)``, bf16, causal,
each window after the same timed calls ``_time_bwd`` makes first
(``_turns``, then the plain version's ``time_ms``), in two arms a round:
``parent``, a window and at once another where one came back empty (as
``chip_smoke._profile`` retries); ``sync+pause``, a synchronize before
each window and a 1-s pause after an empty one.  Six rounds alone, then
twelve beside ``chip_smoke.start_dryrun_cells()``'s child (phase 15 (c),
which the script starts before phase 14).  Prints, per stage and arm,
how many rounds lost their first window and each round's windows (1
recorded, 0 empty).
"""
import os
import sys
import time


def main():
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    sys.path.insert(0, str(cs.SRC))
    import repro_torch  # noqa: F401
    from torch.profiler import ProfilerActivity, profile
    stamp = cs.card_stamp()
    print("[windows]", stamp, torch.__version__, flush=True)
    cs.phase_build(stamp)
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    args = cs._bwd_inputs(torch, (2, 4096, 24, 8, 128, True), torch.bfloat16)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")

    def fn():
        return flash_attention_bwd(*args)

    def window():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        return bool(cs.device_rows(prof))

    def take(style):
        seq = ""
        for _ in range(3):
            if style == "sync+pause":
                torch.cuda.synchronize()
            ok = window()
            seq += "1" if ok else "0"
            if ok:
                break
            if style == "sync+pause":
                time.sleep(1.0)
        return seq

    def stage(name, rounds=6):
        got = {"parent": [], "sync+pause": []}
        t0 = time.perf_counter()
        for _ in range(rounds):
            for style in got:
                cs._turns(torch, fn, None, flush)
                cs.time_ms(torch, lambda: flash_attention_bwd_ref(*args),
                           flush)
                got[style].append(take(style))
        print(f"[windows] {name} ({time.perf_counter() - t0:.1f} s): "
              + "; ".join(f"{k}: first window empty "
                          f"{sum(s[0] == '0' for s in v)} of {len(v)}, "
                          f"windows {' '.join(v)}"
                          for k, v in got.items()), flush=True)

    stage("alone")
    job = cs.start_dryrun_cells()
    stage("beside the dry-run child")
    print(f"[windows] child alive {job[0].is_alive()}", flush=True)
    stage("beside the dry-run child, later")
    print(f"[windows] child alive {job[0].is_alive()}", flush=True)
    job[0].kill()
    job[0].join(10)


if __name__ == "__main__":
    main()
