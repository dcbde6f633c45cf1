"""Rematerialization of the training forwards (`remat`).

The JAX trainers wrap their forward in `jax.checkpoint` with the
`dots_saveable` policy: matmul outputs are kept for the backward, every
other activation is recomputed there. PyTorch's non-reentrant
`torch.utils.checkpoint` recomputes a whole region at the first use of any
of its saved tensors, so one region around a whole forward would cut no
peak; the port checkpoints regions of its own (each object's NeRF, each
bender, the sort-free composite, the autoencoder's halves), each under a
selective policy that saves the outputs of matmuls and convolutions
(`mm`, `addmm`, `bmm`, `baddbmm`, `convolution`) and recomputes the rest.

Two rules keep a recompute equal to the forward it replays:
- random draws are made outside the regions and passed in (checkpoint
  restores the global generators, not the explicit ones of
  utils/random.py::RngStreams);
- the running statistics of the norms are updated by the first run only
  (models/layers.py::frozen_running_statistics);
- under a parallel mesh, the batch-wide sums reduce over the group of the
  first run (parallel/mesh.py::restored_scope: the recompute runs in the
  backward, outside the forward's ray-split region).
A region whose forward takes a derivative itself (the bender's Hutchinson
divergence) runs as a plain region: the selective policy cannot replay a
backward taken inside it.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from playableenvironments_tpu_torch.models.layers import frozen_running_statistics
from playableenvironments_tpu_torch.parallel import mesh as mesh_lib


@functools.lru_cache(maxsize=None)
def _saved_ops() -> frozenset:
    aten = torch.ops.aten
    return frozenset({aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default,
                      aten.convolution.default})


def _policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _saved_ops() else CheckpointPolicy.PREFER_RECOMPUTE


def _selective_contexts():
    return create_selective_checkpoint_contexts(_policy)


def checkpointed(fn, *args, selective: bool = True):
    """fn(*args) as one rematerialized region: its activations are
    recomputed in the backward, except, with `selective`, the outputs of
    matmuls and convolutions. Running statistics move on the first run
    only. Outside grad mode fn simply runs."""
    if not torch.is_grad_enabled():
        return fn(*args)
    runs = [0]
    scope = mesh_lib.reduction_scope()

    def body(*inner):
        runs[0] += 1
        if runs[0] == 1:
            return fn(*inner)
        with frozen_running_statistics(), mesh_lib.restored_scope(scope):
            return fn(*inner)

    if selective:
        return checkpoint(body, *args, use_reentrant=False, context_fn=_selective_contexts)
    return checkpoint(body, *args, use_reentrant=False)
