#!/usr/bin/env python3
"""What the 2-CTA clusters with their multicast and the grouped launch each
buy the B1 kernel (csrc/fused_nerf.cu), by ablation, on one CUDA card.

    python3 scripts/ablate_adain_nerf.py

Builds csrc/fused_nerf.cu, each into a library of its own (the nvcc builds
run together):
- cluster2: as it is (clusters of 2 CTAs that multicast every weight slot);
- cluster1: with -DADAIN_CLUSTER=1 (one CTA per tile, each streaming the
  whole weight image for its own tile);
- cluster2_release_cluster: as it is, but with the consumers' remote slot
  releases made `mbarrier.arrive.release.cluster` (a copy of
  csrc/nerf_wgmma.cuh with that one line changed), the form that a first
  build of the kernel had.
It times the tennis frame's four objects (chip_smoke.py phase 2's inputs:
17,280 + 3 x 46,080 points, each object its own seeded weights) through each
library two ways: one grouped launch for the frame, and one launch per
object. Each time is taken as the wrapper is called (CUDA events around one
call, median of 20 after 3 warm-ups) and back to back (events around 20
calls enqueued together, per call: the kernels without the wrapper's host
time). The six variants run in turns, twice (forward order, then
reversed). Prints one line per variant and turn, each build's clusters
placed at once, and the card.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARRIVE = 'asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote_bar) : "memory");'
ARRIVE_CLUSTER = ARRIVE.replace("mbarrier.arrive.shared", "mbarrier.arrive.release.cluster.shared")


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("ablate_adain_nerf: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from playableenvironments_tpu_torch.config import scene_from_yaml
    from playableenvironments_tpu_torch.models.encoding import positional_encoding
    from playableenvironments_tpu_torch.models.layers import initialize_
    from playableenvironments_tpu_torch.models.nerf import AdaInNerfMLP
    from playableenvironments_tpu_torch.ops import fused_nerf

    # The release-at-cluster-scope variant: a source that includes a copy of
    # the header with the remote arrive changed, both in the build directory.
    header = (fused_nerf._CSRC / "nerf_wgmma.cuh").read_text()
    if header.count(ARRIVE) != 1:
        raise RuntimeError("the remote arrive of csrc/nerf_wgmma.cuh no longer matches")
    build = fused_nerf._BUILD_DIR
    build.mkdir(parents=True, exist_ok=True)
    (build / "nerf_wgmma_release_cluster.cuh").write_text(header.replace(ARRIVE, ARRIVE_CLUSTER))
    variant = build / "fused_nerf_release_cluster.cu"
    variant.write_text(fused_nerf._SOURCE.read_text().replace(
        '#include "nerf_wgmma.cuh"', '#include "nerf_wgmma_release_cluster.cuh"'))

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(fused_nerf.build_kernels, (fused_nerf._SOURCE, variant)),
                  pool.submit(fused_nerf.build_kernels, (fused_nerf._SOURCE,), ("ADAIN_CLUSTER=1",))]
        for b in builds:
            b.result()
    libraries = {"cluster2": fused_nerf.adain_library(), "cluster1": fused_nerf.adain_library(("ADAIN_CLUSTER=1",))}
    release_cluster = ctypes.CDLL(str(fused_nerf._library_path(variant)))
    for fn in ("fused_adain_nerf_group_launch", "fused_adain_nerf_max_clusters", "fused_adain_nerf_cluster_size"):
        getattr(release_cluster, fn).argtypes = getattr(libraries["cluster2"], fn).argtypes
        getattr(release_cluster, fn).restype = ctypes.c_int
    libraries["cluster2_release_cluster"] = release_cluster

    scene = scene_from_yaml(os.path.join(REPO, "configs", "tennis.yaml"))
    cfg = scene.object_models[0].nerf
    generator = torch.Generator().manual_seed(0)
    items = []
    for _, rays, samples in chip_smoke.TENNIS_LAUNCHES:
        nerf = initialize_(AdaInNerfMLP(cfg, scene.object_models[0].style_features, device="cuda"), generator)
        positions = torch.rand(rays * samples, 3, generator=generator) * 2.0 - 1.0
        encoded = positional_encoding(positions, cfg.position_encoder.octaves, True).to("cuda", torch.bfloat16)
        style = torch.randn(rays, 64, generator=generator).to("cuda")
        with torch.no_grad():
            mods = [*fused_nerf.fold_adain_stats(nerf.adain_0, style),
                    *fused_nerf.fold_adain_stats(nerf.adain_1, style)]
        items.append(fused_nerf.AdaInNerfItem(nerf.kernel_weights(), encoded, *mods, samples))

    def grouped():
        return fused_nerf.fused_adain_nerf_group(cfg, items)

    def per_object():
        return [fused_nerf.fused_adain_nerf_group(cfg, [item]) for item in items]

    variants = [(name, mode, call) for name in libraries
                for mode, call in (("grouped", grouped), ("per_object", per_object))]
    out = items[0].weights.packed["w_out"].shape[1]
    for name, lib in libraries.items():
        print(f"{name}: {lib.fused_adain_nerf_cluster_size()} CTAs a cluster, "
              f"{lib.fused_adain_nerf_max_clusters(cfg.layers_width, out)} clusters placed at once")
    with torch.no_grad():
        for turn, order in enumerate((variants, variants[::-1])):
            for name, mode, call in order:
                fused_nerf._library = lambda lib=libraries[name]: lib
                ms = chip_smoke.cuda_ms(call)
                back_to_back = chip_smoke.cuda_ms_back_to_back(call)
                print(f"turn {turn} {name:24s} {mode:10s} {ms:.4f} ms a frame as called, "
                      f"{back_to_back:.4f} back to back", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
