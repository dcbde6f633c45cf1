#!/usr/bin/env python3
"""Export a JAX checkpoint to an `.npz` the PyTorch port reads.

Reads a `checkpoint_<step>` directory written by
playableenvironments_tpu/train/checkpointing.py::save_checkpoint (any
phase) and writes its `params` and `batch_stats` trees and its step to one
`.npz`: each leaf under its "/"-joined path ("params/composer/
object_model_0/nerf/backbone_0/kernel"), a "/" inside a flax name written
"%2F" and a "%" written "%25"; the step under "step". The optimizer's
moments are not carried: a JAX run resumes in JAX, and the port's own
checkpoints carry its whole state.

    python3 scripts/export_flax_checkpoint.py CHECKPOINT_DIR OUT.npz

In the port, `compat/from_flax.py::load_npz` reads the file back into the
nested mapping that `load_environment_model`, `load_autoencoder` and
`load_playable` take. Imports the JAX package, orbax and numpy only.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def escape_key(name: str) -> str:
    return str(name).replace("%", "%25").replace("/", "%2F")


def flatten(tree, prefix: str, out: dict) -> dict:
    for name, value in tree.items():
        path = f"{prefix}/{escape_key(name)}"
        if hasattr(value, "items"):
            flatten(value, path, out)
        else:
            out[path] = np.asarray(value)
    return out


def export(checkpoint: str, out_path: str) -> dict:
    """Write `out_path` from the checkpoint directory; :return: the arrays."""
    from playableenvironments_tpu.train.checkpointing import _checkpointer

    full = _checkpointer().restore(os.path.abspath(checkpoint))
    arrays = {}
    for kind in ("params", "batch_stats"):
        flatten(full.get(kind) or {}, kind, arrays)
    arrays["step"] = np.asarray(full["step"], np.int64)
    np.savez(out_path, **arrays)
    return arrays


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint", help="a checkpoint_<step> directory written by the JAX package")
    parser.add_argument("out", help="the .npz to write")
    args = parser.parse_args(argv)
    arrays = export(args.checkpoint, args.out)
    print(f"{args.out}: {len(arrays) - 1} arrays, step {int(arrays['step'])}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
