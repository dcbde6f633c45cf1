#!/usr/bin/env python3
"""Where the time of B3's per-tile kernel goes, by ablation, on one CUDA card.

    python3 scripts/ablate_backbone_bwd.py

Builds csrc/fused_backbone.cu as it is and in variants with one part of
backbone_bwd_tile_kernel taken out (its bulk stores of X and G; its column
sums), each into a library of its own, and times the backward's three
kernels (CUDA events, median of 7) at the phase-2 launch sizes, the
variants in turns, twice. The variants compute wrong gradients: they only
time. Prints one line per variant, size and turn, and the card.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def variants(source: str) -> dict:
    """{name: CUDA source} of the ablations; each must change the source."""
    out = {
        "as_is": source,
        "no_bulk_stores": source.replace("bulk_store(x_scr", "if (n_points < 0) bulk_store(x_scr")
                                .replace("bulk_store(g_scr", "if (n_points < 0) bulk_store(g_scr"),
        "no_column_sums": source.replace("  constexpr int N = W / 4;  // a thread's values",
                                         "  return;\n  constexpr int N = W / 4;  // a thread's values"),
    }
    for name, text in out.items():
        if name != "as_is" and text == source:
            raise RuntimeError(f"variant {name} no longer matches csrc/fused_backbone.cu")
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("ablate_backbone_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    from playableenvironments_tpu_torch.config import NerfMLPConfig
    from playableenvironments_tpu_torch.ops import fused_nerf

    build = fused_nerf._BUILD_DIR
    build.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in variants(fused_nerf._BACKBONE_SOURCE.read_text()).items():
        paths[name] = build / f"fused_backbone_{name}.cu"
        paths[name].write_text(text)
    fused_nerf.build_kernels(tuple(paths.values()))
    libraries = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(fused_nerf._library_path(path)))
        lib.fused_backbone_bwd_launch.argtypes = fused_nerf._backbone_library().fused_backbone_bwd_launch.argtypes
        lib.fused_backbone_bwd_launch.restype = ctypes.c_int
        libraries[name] = lib

    cfg = NerfMLPConfig(layers_width=256, backbone_layers_count=8, skip_layer_idx=4, compute_dtype="bfloat16",
                        use_fused_backbone=True)
    generator = torch.Generator().manual_seed(0)
    packed = {}
    for i, w_in in enumerate(fused_nerf._backbone_sizes(cfg, 63)):
        packed[f"w{i}"] = (torch.randn(w_in, 256, generator=generator) / w_in ** 0.5).cuda()
        packed[f"b{i}"] = (torch.randn(256, generator=generator) * 0.1).cuda()
    packed["w_alpha"] = (torch.randn(256, 1, generator=generator) * 0.2).cuda()
    packed["b_alpha"] = torch.tensor([0.1]).cuda()
    for turn, order in enumerate((list(libraries), list(reversed(libraries)))):
        for name in order:
            fused_nerf._backbone_library = lambda lib=libraries[name]: lib
            for points in (18432, 147456):
                encoded = (torch.rand(points, 63, generator=generator).cuda() * 2 - 1).to(torch.bfloat16)
                g_h = torch.randn(points, 256, generator=generator).cuda() * 1e-3
                g_alpha = torch.randn(points, generator=generator).cuda() * 1e-3
                runs = [fused_nerf.backbone_bwd_breakdown(cfg, packed, encoded, g_h, g_alpha) for _ in range(8)][1:]
                ms = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
                print(f"turn {turn} {name:15s} {points:6d} points: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()),
                      flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
