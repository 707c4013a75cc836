#!/usr/bin/env python3
"""How deep a seeded LM stack stays comparable in f32, on one CUDA card.

  python3 scripts/lm_f32_chaos.py [--arch ARCH ...] [--depths N ...]

For each arch (default: whisper-medium and qwen2-vl-2b, the families of
``chip_smoke.py`` phase 13; zamba2-7b and mamba2-1.3b also run) it draws the
f32 masters as the serving engine does (seed 0, on the card) and takes
``chip_smoke.py``'s f32 inputs (``f32_inputs``: a 64-token prompt, whisper's
1500 audio frames).  At each depth (the stacks cut as ``cut_depth`` cuts
them; the encoder-decoder at n encoder and n decoder layers) it prints the
prefill through the ``flash_attention`` kernel against the prefill through
the plain attention, and the chaos: how far ``CHAOS_NOISE`` relative noise
on the input (``f32_inputs``' perturbation) moves the plain prefill's
logits, both as max |diff| / max |logit|.  Where the chaos is far above
``LOGITS_REL_TOL``, no two f32 summation orders agree to it either, so the
whole-prefill check of ``chip_smoke.py`` (``F32_CHECK_LAYERS``) runs at a
depth where both are below it.  Exits non-zero without a CUDA card.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FAMILY = {"whisper-medium": "encdec", "qwen2-vl-2b": "vlm",
          "zamba2-7b": "hybrid", "mamba2-1.3b": "ssm"}
DEPTHS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 28, 48, 81)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=["whisper-medium",
                                                  "qwen2-vl-2b"],
                    choices=sorted(FAMILY))
    ap.add_argument("--depths", nargs="+", type=int, default=DEPTHS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("[fail] no CUDA device: this script runs the LMs on a GPU",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import layers
    from repro_torch.models.api import build
    from repro_torch.models.params import init_params

    stamp = cs.card_stamp()
    dev = torch.device("cuda")
    for arch in args.arch:
        family = FAMILY[arch]
        cfg = get_config(arch).replace(compute_dtype="float32")
        params = init_params(build(cfg).decls,
                             torch.Generator(device=dev).manual_seed(0), dev)
        _, batch, noisy = cs.f32_inputs(torch, family, cfg)
        # the hybrid's stack needs one shared attention block
        lowest = cfg.shared_attn_every if family == "hybrid" else 1
        for n in sorted(d for d in set(args.depths)
                        if lowest <= d <= cfg.num_layers):
            c, p = cs.cut_depth(family, cfg, params, n)
            want = cs.prefill_with(torch, c, p, batch, flash_attention_ref)
            got = cs.prefill_with(torch, c, p, batch, layers.flash_attention)
            moved = cs.prefill_with(torch, c, *noisy(p, batch),
                                    flash_attention_ref)
            top = want.abs().max()
            print(f"[chaos] {arch} f32 at {n} layers"
                  + (f" (and {n} encoder layers)" if family == "encdec"
                     else "")
                  + f": kernel vs plain "
                  f"{float((got - want).abs().max() / top):.2e}, "
                  f"{cs.CHAOS_NOISE:g} noise on the input moves the logits "
                  f"{float((moved - want).abs().max() / top):.2e} of their "
                  f"largest (tolerance {cs.LOGITS_REL_TOL})  [{stamp}]",
                  flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
