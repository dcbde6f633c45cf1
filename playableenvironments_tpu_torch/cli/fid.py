"""Standalone FID between two image directories.

Port of playableenvironments_tpu/cli/fid.py:

    python -m playableenvironments_tpu_torch.cli.fid <dir_a> <dir_b> [--batch_size 32] \
        [--inception_weights weights.npz] [--device cuda|cpu]

Every .png/.jpg/.jpeg/.bmp under each directory, in sorted order, is
embedded `--batch_size` images at a time. The default embedder is VGG19 on
seeded random weights (eval.distribution_metrics; self-consistent only);
with `--inception_weights` (an .npz of flax-path keys,
eval.inception_v3.load_inception_params_npz) it is InceptionV3 at 299x299.
Prints and returns the distance. Runs on the card by default; without one
it raises unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp")


def _image_paths(directory: str):
    paths = []
    for root, _, files in sorted(os.walk(directory)):
        for name in sorted(files):
            if name.lower().endswith(IMAGE_EXTENSIONS):
                paths.append(os.path.join(root, name))
    if not paths:
        raise SystemExit(f"no images found under {directory}")
    return paths


def main() -> float:
    parser = argparse.ArgumentParser(description="FID between two image dirs")
    parser.add_argument("dir_a")
    parser.add_argument("dir_b")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--inception_weights", default=None,
                        help="optional InceptionV3 weights .npz (eval.inception_v3.load_inception_params_npz) for "
                             "published-number-comparable values; the default embedder is self-consistent only")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    import numpy as np

    from playableenvironments_tpu_torch.data.video import _load_image
    from playableenvironments_tpu_torch.eval.distribution_metrics import IncrementalFID
    from playableenvironments_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    embed_fn = None
    if args.inception_weights:
        from playableenvironments_tpu_torch.compat.from_flax import load_inception
        from playableenvironments_tpu_torch.eval.inception_v3 import (
            InceptionV3Features, inception_image_embedder, load_inception_params_npz,
        )

        net = InceptionV3Features(device=device)
        load_inception(net, load_inception_params_npz(args.inception_weights))
        embed_fn = inception_image_embedder(net.requires_grad_(False).eval())
    fid = IncrementalFID(embed_fn, device=device)

    for which, directory in (("reference", args.dir_a), ("generated", args.dir_b)):
        paths = _image_paths(directory)
        update = fid.update_reference if which == "reference" else fid.update_generated
        for begin in range(0, len(paths), args.batch_size):
            update(np.stack([_load_image(p) for p in paths[begin:begin + args.batch_size]]))

    value = fid.compute()
    print(f"fid: {value:.6f}")
    return value


if __name__ == "__main__":
    main()
