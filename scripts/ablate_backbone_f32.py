#!/usr/bin/env python3
"""Where the time of B2-f32 and of B3-f32's tile kernel goes, by ablation,
on one CUDA card.

    python3 scripts/ablate_backbone_f32.py

Builds csrc/fused_backbone_f32.cu as it is and in variants with one part
of the tile kernels (forward and backward) taken out: the weight slots' bulk
copies (the producer marks each slot landed without copying it), the
tensor-core products (the consumers wait, split and add as before but issue
no wgmma), or both; each into a library of its own. Times B2-f32's launch
and B3-f32's three kernels (CUDA events, median of 3 after one warm-up) at
the 14a shapes of 147,456 and 1,310,720 points, the variants in turns,
twice. The weight-gradient kernel keeps its products in every variant. The
variants compute wrong outputs: they only time. Prints one line per
variant, size and turn, and the card.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPY = ("  mbar_expect_tx(r.full + 8 * r.stage, bytes);\n"
        "  bulk_load(r.slots + r.stage * kStageBytes, src, bytes, r.full + 8 * r.stage);\n")
PRODUCTS = "  mma3<H>(acc, big, small, plain_desc(slot), plain_desc(slot + n_all * 32), scale_d);\n"


def variants(source: str) -> dict:
    """{name: CUDA source} of the ablations; each part taken out must occur
    once in the source."""
    for part in (COPY, PRODUCTS):
        if source.count(part) != 1:
            raise RuntimeError(f"csrc/fused_backbone_f32.cu no longer holds {part.strip()!r} once")
    no_copies = source.replace(COPY, "  mbar_arrive(r.full + 8 * r.stage);\n")
    return {
        "as_is": source,
        "no_weight_copies": no_copies,
        "no_products": source.replace(PRODUCTS, "  (void)slot;\n"),
        "neither": no_copies.replace(PRODUCTS, "  (void)slot;\n"),
    }


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("ablate_backbone_f32: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import cuda_ms, phase5_inputs
    from playableenvironments_tpu_torch.ops import fused_nerf

    build = fused_nerf._BUILD_DIR
    build.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in variants(fused_nerf._BACKBONE_F32_SOURCE.read_text()).items():
        paths[name] = build / f"fused_backbone_f32_{name}.cu"
        paths[name].write_text(text)
    fused_nerf.build_kernels(tuple(paths.values()))
    reference = fused_nerf._backbone_f32_library()
    libraries = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(fused_nerf._library_path(path)))
        for fn in ("backbone_f32_pack_launch", "backbone_f32_fwd_launch", "backbone_f32_bwd_launch"):
            getattr(lib, fn).argtypes = getattr(reference, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libraries[name] = lib

    inputs = {points: phase5_inputs(points, seed=41, compute_dtype="float32") for points in (147456, 1310720)}
    for turn, order in enumerate((list(libraries), list(reversed(libraries)))):
        for name in order:
            fused_nerf._backbone_f32_library = lambda lib=libraries[name]: lib
            for points, (cfg, packed, encoded, g_h, g_alpha) in inputs.items():
                with torch.no_grad():
                    buffers = fused_nerf.backbone_f32_buffers(cfg, packed)
                    fwd_ms = cuda_ms(lambda: fused_nerf.backbone_f32_fwd(cfg, packed, encoded, buffers), warmup=1,
                                     reps=3)
                    runs = [fused_nerf.backbone_f32_bwd_breakdown(cfg, packed, encoded, g_h, g_alpha, buffers)
                            for _ in range(4)][1:]
                ms = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
                print(f"turn {turn} {name:16s} {points:7d} points: B2-f32 {fwd_ms:.4f} ms, B3-f32 "
                      + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
