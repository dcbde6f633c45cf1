#!/usr/bin/env python3
"""Where the time of the rollout kernels B4 and B5 goes, by ablation, on one
CUDA card.

    python3 scripts/ablate_rollout.py

Builds csrc/fused_rollout.cu as it is and in variants with one part of the
cluster kernels taken out, each into a library of its own, and times the
launches apart (CUDA events around each, median of 7 after one warm-up) at
the phase-3 shape (16 x 9, F 256, 2 layers), the variants in turns, twice:
B4's image gather and rollout (with residuals), B5's gather, recurrence and
weight gradients. Variants:
- no_exchange: no cluster-wide wait at all (each CTA runs on with whatever
  its shared memory holds);
- no_products: the products wait for and release every weight chunk of the
  ring but do no arithmetic.
The variants compute wrong results: they only time. Prints one line per
variant and turn, and the card.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARRIVE = "  if ((int)threadIdx.x < n) mbar_arrive_cluster(mapa(bar, threadIdx.x));\n"
WAIT = "  mbar_wait<true>(bar, phase);\n"
PRODUCT = "    if (tl.active) {\n      const float* w = r.slots"


def variants(source: str) -> dict:
    """{name: CUDA source} of the ablations; each must change the source."""
    out = {
        "as_is": source,
        "no_exchange": source.replace(ARRIVE, "").replace(WAIT, ""),
        "no_products": source.replace(PRODUCT, PRODUCT.replace("tl.active", "tl.active && K < 0")),
    }
    for name, text in out.items():
        if name != "as_is" and text == source:
            raise RuntimeError(f"variant {name} no longer matches csrc/fused_rollout.cu")
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("ablate_rollout: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from playableenvironments_tpu_torch.ops import fused_nerf
    from playableenvironments_tpu_torch.ops import fused_rollout as fr

    build = fused_nerf._BUILD_DIR
    build.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in variants(fused_nerf._ROLLOUT_SOURCE.read_text()).items():
        paths[name] = build / f"fused_rollout_{name}.cu"
        paths[name].write_text(text)
    fused_nerf.build_kernels(tuple(paths.values()))
    reference = fr._library()
    libraries = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(fused_nerf._library_path(path)))
        for fn in ("fused_rollout_fwd_launch", "fused_rollout_bwd_launch"):
            getattr(lib, fn).argtypes = getattr(reference, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libraries[name] = lib

    box = ((-0.75, 0.75), (-0.5, 0.5), (0.0, 2.15))
    cfg = fr.RolloutConfig(2, True, 0.0, tuple(hi - lo for lo, hi in box))
    anim = chip_smoke.phase3_animation_config()
    packed, inputs, cots = chip_smoke.rollout_case(anim, box, chip_smoke.PHASE3_BATCH,
                                                   chip_smoke.PHASE3_OBSERVATIONS, 10, "cuda")
    gt, A = chip_smoke.PHASE3_GT, anim.actions_count
    with torch.no_grad():
        _, res = fr.fused_rollout_fwd(cfg, packed, *inputs, gt, True)
        for turn, order in enumerate((list(libraries), list(reversed(libraries)))):
            for name in order:
                fr._library = lambda lib=libraries[name]: lib
                ms = {}
                for key, call in (("B4", lambda: fr.rollout_fwd_breakdown(cfg, packed, inputs, gt, True)),
                                  ("B5", lambda: fr.rollout_bwd_breakdown(cfg, packed, gt, res, cots, A))):
                    runs = [call() for _ in range(8)][1:]
                    ms.update({f"{key} {k}": statistics.median(r[k] for r in runs) for k in runs[0]})
                print(f"turn {turn} {name:12s} " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
