#!/usr/bin/env python3
"""B1 at the reconstruction creator's batch-4 launch, on real render inputs.

    python3 scripts/check_b1_batch.py

Writes chip_smoke.py phase 11's dataset (the test split's first 4 frames),
renders them as one batch through FrameRenderer with the tennis model at
full width (seeded weights) and captures the grouped B1 launch. For each
object of that launch it prints the largest output magnitudes, the kernel's
error against plain_adain_nerf, both versions' errors against the same
function with every sum in float64 (the same bf16 operands), how the error
sits over the points (all points, points inside the object's box, the
points of the largest encoded coordinates), and whether the grouped launch
equals one launch of that object alone bit for bit. Needs one CUDA card.
"""

from __future__ import annotations

import os
import sys
import tempfile


def f64_reference(cfg, packed, encoded, s0, b0, s1, b1, samples):
    """plain_adain_nerf with the same bf16 operands and every product and sum
    in float64."""
    import torch

    def bf(x):
        return x.to(torch.bfloat16).double()

    def per_point(mod):
        return mod.double().repeat_interleave(samples, dim=0)

    enc = bf(encoded.float())
    h = enc
    for i in range(cfg.backbone_layers_count):
        if i == cfg.skip_layer_idx:
            h = torch.cat([h, enc], dim=-1)
        h = torch.relu(bf(h) @ bf(packed[f"w{i}"]) + packed[f"b{i}"].double())
    alpha = (bf(h) @ bf(packed["w_alpha"]) + packed["b_alpha"].double())[..., 0]
    f = torch.relu((bf(h) @ bf(packed["w_f0"])) * per_point(s0) + per_point(b0))
    f = torch.relu((bf(f) @ bf(packed["w_f1"])) * per_point(s1) + per_point(b1))
    return bf(f) @ bf(packed["w_out"]) + packed["b_out"].double(), alpha


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("check_b1_batch: needs a CUDA card", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke as cs
    from playableenvironments_tpu_torch.cli.common import build_dataset
    from playableenvironments_tpu_torch.cli.play import InteractiveSession
    from playableenvironments_tpu_torch.config import scene_from_yaml
    from playableenvironments_tpu_torch.ops import fused_nerf

    fused_nerf.build_kernels()
    cs.DATA_SPLITS = {"test": (1, 4)}
    scene = scene_from_yaml(os.path.join(repo, "configs", "tennis.yaml"))
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "tennis")
        cs.write_tennis_dataset(root)
        test = build_dataset(cs.tennis_config(repo, root, observations_count=1, skip_frames=0), "test")
        batch = next(test.iterate_batches(4, shuffle=False))
    session = InteractiveSession.from_scene(scene, image_size=cs.IMAGE_SIZE, patch_strides=cs.STRIDES,
                                            focal_length_multiplier=cs.FOCAL_LENGTH_MULTIPLIER, device="cuda",
                                            seed=0)
    grouped = fused_nerf.fused_adain_nerf_group
    captured = []

    def capture(cfg, items):
        outs = grouped(cfg, items)
        captured.append((cfg, items, outs))
        return outs

    fused_nerf.fused_adain_nerf_group = capture
    with torch.no_grad():
        session.renderer.render(session.renderer.encode(batch))
    fused_nerf.fused_adain_nerf_group = grouped
    cfg, items, outs = captured[0]
    names = [om.name for om in scene.object_models]
    with torch.no_grad():
        for name, item, (feats, alpha) in zip(names, items, outs):
            args = (item.encoded, item.scale0, item.bias0, item.scale1, item.bias1)
            plain = fused_nerf.plain_adain_nerf(cfg, item.weights.packed, *args, item.samples_per_ray)
            exact = f64_reference(cfg, item.weights.packed, *args, item.samples_per_ray)
            alone = fused_nerf.fused_adain_nerf(cfg, item.weights, *args, samples_per_ray=item.samples_per_ray)
            identical = all(torch.equal(a, b) for a, b in zip(alone, (feats, alpha)))
            coords = item.encoded.float()[:, :3].abs().amax(dim=-1)
            inside = coords <= 1.0  # positions divided by the box size: |x| <= 1 inside or near the box
            far = coords >= torch.quantile(coords[::max(1, coords.numel() // 100000)], 0.99)
            for label, got, ref, ex in (("features", feats, plain[0], exact[0]), ("alpha", alpha, plain[1], exact[1])):
                ex = ex.float()
                diff = (got - ref).abs()
                row = diff if diff.dim() == 1 else diff.amax(dim=-1)
                over = diff > 3e-2 + 1e-2 * ref.abs()
                over_points = over if over.dim() == 1 else over.any(dim=-1)
                print(f"{name} {label}: {item.encoded.shape[0]} points, |ref| max {ref.abs().max().item():.3e} "
                      f"mean {ref.abs().mean().item():.3e}; kernel - plain max {diff.max().item():.3e} mean "
                      f"{diff.mean().item():.3e}; kernel - f64 max {(got - ex).abs().max().item():.3e} mean "
                      f"{(got - ex).abs().mean().item():.3e}; plain - f64 max {(ref - ex).abs().max().item():.3e} "
                      f"mean {(ref - ex).abs().mean().item():.3e}; mean err inside the box "
                      f"{row[inside].mean().item() if inside.any() else 0.0:.3e}, at the 1% farthest points "
                      f"{row[far].mean().item():.3e}; {int(over_points.sum())} points over 3e-2 + 1e-2 |ref|; "
                      f"grouped == alone: {identical}")
            print(f"{name}: encoded |x| max {coords.max().item():.3e}, {int(inside.sum())} of {coords.numel()} "
                  f"points within the box; modulation |scale0| max {item.scale0.abs().max().item():.3e}, |bias0| "
                  f"max {item.bias0.abs().max().item():.3e}, |scale1| max {item.scale1.abs().max().item():.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
