"""Process meshes for data and ray parallelism, and the device mesh of the
eval ray split.

Port of playableenvironments_tpu/parallel/mesh.py. The JAX package runs one
program over a `jax.sharding.Mesh` and lets XLA insert the collectives. The
port runs one process per device over `torch.distributed` (NCCL by default
on the card, gloo on the CPU) and writes each collective out:

- `Mesh`: the (data, rays) layout of the processes, rank = data_index *
  rays + rays_index (the JAX mesh's row-major reshape), with the process
  groups of this rank's data column and rays row. `create_mesh` (a data
  axis over every process) and `create_2d_mesh` build it; a mesh whose size
  is not the number of processes raises.
- `shard_batch`: this rank's slice of a global batch; `replicate`
  broadcasts a module's state from rank 0; `verify_replication` compares
  one crc32 fingerprint a rank in one collective.
- inside `Mesh.activate()`, what JAX computes over the global batch is
  computed over the group: `global_sum` (an all-reduce whose backward is
  the same all-reduce) carries the batch norms' moments, the masked means
  and the other batch-wide sums of the losses; `ShardedStreams` makes each
  rank draw its slice of the global batch's random draws;
  `reduce_gradients` averages the gradients over the ranks after backward.
- the ray split of training (`ray_split`, `gather_rays`,
  `RaySliceStreams`, `ray_split_region`): each rank of a rays row renders
  its slice of the sampled rays and the per-ray outputs are gathered with
  an all-reduce of zero-filled full-length buffers.
- `DeviceMesh` / `create_device_mesh`: the eval ray split of one process
  over a list of devices (render/fast.py::render_rays_fast_sharded).

Without a process group (one process, `maybe_initialize_distributed` not
configured) no collective runs and every code path is the one-device one.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
RAYS_AXIS = "rays"

# How long a collective may wait for its peers before the process group
# raises (a rank that died leaves its peers in the collective).
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _truthy(value: Optional[str]) -> bool:
    """"0", "false" and "no" mean off, as the JAX package's switch reads them."""
    return bool(value) and value.strip().lower() not in ("0", "false", "no")


def distributed_configured() -> bool:
    """Whether this process is one of several: WORLD_SIZE above 1, or the
    JAX package's PE_MULTIHOST switch on."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1 or _truthy(os.environ.get("PE_MULTIHOST"))


def select_backend(device: torch.device, backend: Optional[str] = None) -> str:
    """The process group's backend: `backend`, else PE_DIST_BACKEND, else
    NCCL on the card and gloo on the CPU. NCCL for CPU tensors raises."""
    backend = (backend or os.environ.get("PE_DIST_BACKEND") or ("nccl" if device.type == "cuda" else "gloo")).lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"distributed backend {backend!r}: the port runs nccl or gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend runs on the card; name gloo (PE_DIST_BACKEND=gloo) for the CPU")
    return backend


def rank_device(device, backend: Optional[str] = None, local_rank: Optional[int] = None) -> torch.device:
    """This process's device: the CPU, or the card of its LOCAL_RANK. A rank
    without a card of its own raises unless the caller named gloo, whose
    ranks may share a card (NCCL refuses two ranks on one device)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the plain PyTorch versions")
    local_rank = int(os.environ.get("LOCAL_RANK", "0")) if local_rank is None else local_rank
    count = torch.cuda.device_count()
    if local_rank < count:
        return torch.device("cuda", local_rank)
    named = (backend or os.environ.get("PE_DIST_BACKEND") or "").lower()
    if named != "gloo":
        raise RuntimeError(
            f"local rank {local_rank} has no card of its own ({count} visible): NCCL needs one card a rank; "
            "name gloo (PE_DIST_BACKEND=gloo) to let ranks share cards")
    return torch.device("cuda", local_rank % count)


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if _initialized() else 1


def world_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if _initialized() else 0


def maybe_initialize_distributed(device="cuda", backend: Optional[str] = None,
                                 timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """`torch.distributed.init_process_group` when several processes are
    configured (`distributed_configured`), from torchrun's RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT, then `warmup_collectives`. No-op otherwise:
    a single process must not wait for peers. Sets this process's card.

    :return: whether a process group is up."""
    import torch.distributed as dist

    if _initialized():
        return True
    if not distributed_configured():
        return False
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise ValueError(
            f"WORLD_SIZE={os.environ.get('WORLD_SIZE', '1')} / PE_MULTIHOST need {', '.join(missing)}: launch "
            "each process with torchrun (torchrun --nproc_per_node N -m playableenvironments_tpu_torch.cli...)")
    device = torch.device(device)
    backend = select_backend(device, backend)
    local = rank_device(device, backend)
    if local.type == "cuda":
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), timeout=timeout)
    warmup_collectives(local)
    return True


@contextlib.contextmanager
def process_group(device="cuda"):
    """A CLI's run inside `maybe_initialize_distributed`'s process group.
    Where this call brought the group up, a run that ends without an error
    takes it down again: a barrier, so that no rank leaves while another is
    still in a collective, then `destroy_process_group`, which joins the
    backend's threads before the interpreter exits (a thread still running
    native code while the interpreter finalizes aborts the process). A
    group that was up before, or a run that raised, is left as it is."""
    import torch.distributed as dist

    created = not _initialized() and maybe_initialize_distributed(device)
    yield
    if created:
        barrier()
        dist.destroy_process_group()


def barrier(device=None) -> None:
    """Every process waits for the others: one all-reduce of a one-element
    tensor on `device` (the backend's own barrier needs to be told the card
    under NCCL). No-op in one process."""
    import torch.distributed as dist

    if world_size() <= 1:
        return
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    dist.all_reduce(torch.zeros(1, device=device))


def warmup_collectives(device=None) -> None:
    """One collective right after init, while every process is still at the
    rendezvous: the backend's communicator is made then, not under the first
    step's skew."""
    barrier(device)


def compile_barrier(fn):
    """The JAX package compiles the step on every process, then meets at a
    barrier before the first dispatch. Eager PyTorch compiles nothing (the
    kernels build at first launch), so this is a barrier; `fn` is returned
    as it is."""
    barrier()
    return fn


# ---------------------------------------------------------------------------
# The process mesh
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class Mesh:
    """The (data, rays) layout of the processes, as this rank sees it.

    :param data_group: the process group of the ranks that share this
        rank's rays index (one per data index), None where data is 1.
    :param rays_group: the ranks that share its data index, None where rays
        is 1.
    :param world_group: every rank, None without a process group.
    """

    data: int
    rays: int
    rank: int
    device: torch.device
    data_group: Any = None
    rays_group: Any = None
    world_group: Any = None
    reduce_seconds: List[float] = field(default_factory=list)

    @property
    def size(self) -> int:
        return self.data * self.rays

    @property
    def data_index(self) -> int:
        return self.rank // self.rays

    @property
    def rays_index(self) -> int:
        return self.rank % self.rays

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, RAYS_AXIS: self.rays}

    @contextlib.contextmanager
    def activate(self):
        """Inside the `with`, batch-wide statistics and sums reduce over the
        data group, gradients over every rank (`reduce_gradients`, from
        train.state.Optimizer.step) and training renders split their rays
        over the rays group. A mesh of one process changes nothing."""
        global _ACTIVE
        previous, _ACTIVE = _ACTIVE, (self if self.size > 1 else None)
        try:
            yield self
        finally:
            _ACTIVE = previous

    def streams(self, rng):
        """`rng` drawing this rank's slice of the global batch's draws."""
        return ShardedStreams(rng, self.data_index, self.data) if self.data > 1 else rng

    def batch_slice(self, global_batch: int) -> slice:
        """This rank's rows of a global batch (contiguous, by data index)."""
        if global_batch % self.data:
            raise ValueError(f"batch {global_batch} does not divide over the data axis ({self.data})")
        local = global_batch // self.data
        return slice(self.data_index * local, (self.data_index + 1) * local)

    def mean_metrics(self, metrics: dict) -> dict:
        """Each scalar metric averaged over the ranks (one all-reduce): the
        global batch's value of a loss that is a mean of equal-sized rank
        means, and the value itself of one already computed over the group."""
        if self.world_group is None or not metrics:
            return metrics
        import torch.distributed as dist

        names = list(metrics)
        stacked = torch.stack([metrics[k].detach().to(self.device, torch.float32).reshape(()) for k in names])
        dist.all_reduce(stacked, group=self.world_group)
        stacked = stacked / self.size
        return dict(zip(names, stacked.unbind()))


_ACTIVE: Optional[Mesh] = None
_RAY_REGION = 0


def active_mesh() -> Optional[Mesh]:
    """The mesh of the `Mesh.activate()` block around the caller (of more
    than one process), or None."""
    return _ACTIVE


def _groups(data: int, rays: int, rank: int):
    """(data group, rays group) of `rank`; every process makes every group,
    in the same order, as torch.distributed.new_group requires."""
    import torch.distributed as dist

    data_group = rays_group = None
    if data > 1:
        for k in range(rays):
            group = dist.new_group([d * rays + k for d in range(data)])
            if rank % rays == k:
                data_group = group
    if rays > 1:
        for d in range(data):
            group = dist.new_group([d * rays + k for k in range(rays)])
            if rank // rays == d:
                rays_group = group
    return data_group, rays_group


def _process_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if _initialized():
        import torch.distributed as dist

        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _build(data: int, rays: int, device) -> Mesh:
    import torch.distributed as dist

    world = world_size()
    if data * rays != world:
        raise ValueError(
            f"a mesh of data={data} x rays={rays} needs {data * rays} processes, one a device, and this run has "
            f"{world}: launch it with torchrun --nproc_per_node {data * rays} (one process cannot drive several "
            "training devices)")
    rank = world_rank()
    data_group, rays_group = _groups(data, rays, rank) if world > 1 else (None, None)
    return Mesh(data, rays, rank, _process_device(device), data_group, rays_group,
                dist.group.WORLD if _initialized() else None)


def create_mesh(data: Optional[int] = None, device=None) -> Mesh:
    """A data axis over every process (`data`, where given, must be their
    number)."""
    return _build(world_size() if data is None else int(data), 1, device)


def create_2d_mesh(data: int = 0, device=None) -> Mesh:
    """A (data, rays) mesh over every process: the batch split over `data`,
    each example's sampled rays over rays = processes / data (0: every
    process on data, rays 1)."""
    world = world_size()
    if data <= 0:
        data = world
    if world % data:
        raise ValueError(f"{world} processes not divisible by data={data}")
    return _build(data, world // data, device)


# ---------------------------------------------------------------------------
# Batches and replicated state
# ---------------------------------------------------------------------------


def shard_batch(batch: Any, mesh: Mesh, leading_axes: int = 0) -> Any:
    """This rank's slice of a global batch: every tensor (of a Batch, a
    SceneEncoding, a dict, list or tuple) cut along its batch axis, which
    comes after `leading_axes` axes, to the rank's contiguous rows."""

    def cut(x):
        if x is None or not torch.is_tensor(x):
            return x
        rows = mesh.batch_slice(x.shape[leading_axes])
        return x.narrow(leading_axes, rows.start, rows.stop - rows.start)

    if hasattr(batch, "__dataclass_fields__"):
        import dataclasses

        return type(batch)(**{f.name: shard_batch(getattr(batch, f.name), mesh, leading_axes)
                              for f in dataclasses.fields(batch)})
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, leading_axes) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, leading_axes) for v in batch)
    return cut(batch)


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a module's state dict, a dict, list or tuple, or one
    tensor, in a fixed order."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict(keep_vars=True).values())
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def replicate(tree: Any, mesh: Optional[Mesh] = None) -> Any:
    """Every rank takes rank 0's copy of `tree` (a module's parameters and
    buffers, or tensors), broadcast in place. With PE_VERIFY_REPLICATION on,
    `verify_replication` checks first that the copies already agree (same
    seed, same checkpoint), as the JAX package does."""
    import torch.distributed as dist

    if world_size() <= 1:
        return tree
    if _truthy(os.environ.get("PE_VERIFY_REPLICATION")):
        verify_replication(tree)
    with torch.no_grad():
        for leaf in _leaves(tree):
            data = leaf.data if isinstance(leaf, torch.nn.Parameter) else leaf
            dist.broadcast(data, src=0)
    return tree


def fingerprint(tree: Any) -> int:
    """crc32 of every leaf's bytes, the leaf index mixed in so that two
    swapped leaves do not cancel."""
    value = 0
    for index, leaf in enumerate(_leaves(tree)):
        data = leaf.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        value = zlib.crc32(data, value ^ (index * 0x9E3779B1 & 0xFFFFFFFF))
    return value


def verify_replication(tree: Any, device=None) -> None:
    """Raise ValueError unless every rank holds bytewise the same leaves:
    one fingerprint a rank, gathered in one all-reduce (each rank writes its
    slot of a zero-filled buffer)."""
    import torch.distributed as dist

    if not _initialized():
        return
    world = world_size()
    slots = torch.zeros(world, dtype=torch.int64, device=_process_device(device))
    slots[world_rank()] = fingerprint(tree)
    dist.all_reduce(slots)
    gathered = slots.tolist()
    if any(v != gathered[0] for v in gathered):
        raise ValueError(
            f"replicate(): state differs across processes — per-process fingerprints {gathered} "
            "(PE_VERIFY_REPLICATION)")


# ---------------------------------------------------------------------------
# Collectives inside an active mesh
# ---------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the backward is the same sum of the
    gradients, the adjoint of a sum that every rank receives."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def reduction_group():
    """The group that batch-wide sums reduce over: the data group of the
    active mesh, every rank inside a ray-split render (whose points are
    split over both axes), None without an active mesh."""
    mesh = _ACTIVE
    if mesh is None:
        return None
    return mesh.world_group if _RAY_REGION else mesh.data_group


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over `reduction_group()`, differentiably; `x` itself
    without one."""
    group = reduction_group()
    return x if group is None else _AllReduceSum.apply(x, group)


# The f32 values of one bucket of the gradient all-reduce (64 MiB).
_BUCKET_ELEMENTS = 1 << 24


def reduce_gradients(parameters: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Every parameter's gradient averaged over the ranks, in buckets of at
    most `_BUCKET_ELEMENTS` f32 values, one all-reduce each: the mean of the
    data ranks' gradients of their losses (each a mean over its slice), and
    within a rays row the sum of the slices' gradients (each rank's loss is
    the whole row's, which the mean over its `rays` copies undoes). The
    seconds it takes, with the card synchronized around it, go into
    `mesh.reduce_seconds`."""
    import torch.distributed as dist

    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads or mesh.world_group is None:
        return
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
    start = time.perf_counter()
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        flat = torch.cat([g.reshape(-1).to(torch.float32) for g in bucket])
        dist.all_reduce(flat, group=mesh.world_group)
        flat /= mesh.size
        offset = 0
        for g in bucket:
            g.copy_(flat[offset : offset + g.numel()].view_as(g))
            offset += g.numel()

    for g in grads:
        if bucket and size + g.numel() > _BUCKET_ELEMENTS:
            flush()
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel()
    if bucket:
        flush()
    if cuda:
        torch.cuda.synchronize(mesh.device)
    mesh.reduce_seconds.append(time.perf_counter() - start)


# ---------------------------------------------------------------------------
# Random draws of a slice of the global batch, or of the rays
# ---------------------------------------------------------------------------


class ShardedStreams:
    """utils.random.RngStreams drawing, on data rank `index` of `count`,
    this rank's rows of the draw that one process makes for the global
    batch: every draw whose leading axis is the batch (or batch-major rows,
    as a flattened (B * T, ...) draw) is made at `count` times that axis and
    cut to the rank's rows. Permutations (over time, not the batch) are the
    global ones."""

    def __init__(self, streams, index: int, count: int):
        self.streams, self.index, self.count = streams, index, count

    def _rows(self, draw, shape):
        shape = tuple(shape)
        full = draw((shape[0] * self.count,) + shape[1:])
        return full.narrow(0, self.index * shape[0], shape[0])

    def uniform(self, stream, shape):
        return self._rows(lambda s: self.streams.uniform(stream, s), shape)

    def normal(self, stream, shape):
        return self._rows(lambda s: self.streams.normal(stream, s), shape)

    def randint(self, stream, high, shape):
        return self._rows(lambda s: self.streams.randint(stream, high, s), shape)

    def gumbel(self, stream, shape):
        return self._rows(lambda s: self.streams.gumbel(stream, s), shape)

    def permutation(self, stream, n):
        return self.streams.permutation(stream, n)


class RaySliceStreams:
    """Streams for the render of rays [start, stop) of `total` along `axis`:
    each draw is made over every ray (`axis` at `total`) and cut to the
    slice, so that the split render draws what the whole one draws. Every
    draw of the composer has the ray axis at 3 ((B, T, C, rays, ...))."""

    def __init__(self, streams, start: int, stop: int, total: int, axis: int = 3):
        self.streams, self.start, self.stop, self.total, self.axis = streams, start, stop, total, axis

    def _slice(self, draw, shape):
        shape = list(shape)
        if len(shape) <= self.axis or shape[self.axis] != self.stop - self.start:
            raise ValueError(f"a draw of shape {tuple(shape)} has no ray axis {self.axis} of the slice's "
                             f"{self.stop - self.start} rays")
        shape[self.axis] = self.total
        return draw(tuple(shape)).narrow(self.axis, self.start, self.stop - self.start)

    def uniform(self, stream, shape):
        return self._slice(lambda s: self.streams.uniform(stream, s), shape)

    def normal(self, stream, shape):
        return self._slice(lambda s: self.streams.normal(stream, s), shape)

    def randint(self, stream, high, shape):
        return self._slice(lambda s: self.streams.randint(stream, high, s), shape)

    def gumbel(self, stream, shape):
        return self._slice(lambda s: self.streams.gumbel(stream, s), shape)

    def permutation(self, stream, n):
        return self.streams.permutation(stream, n)


# ---------------------------------------------------------------------------
# The ray split of training (render/environment_model.py)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def ray_split_region():
    """Inside the `with`, batch-wide sums (the NeRFs' AdaIN statistics)
    reduce over every rank: the points are split over data and rays."""
    global _RAY_REGION
    _RAY_REGION += 1
    try:
        yield
    finally:
        _RAY_REGION -= 1


def reduction_scope() -> tuple:
    """What `reduction_group()` reads (the active mesh, the ray-split
    region), for a recompute to take again (utils/remat.py)."""
    return _ACTIVE, _RAY_REGION


@contextlib.contextmanager
def restored_scope(scope: tuple):
    """Inside the `with`, `reduction_group()` answers as it did when
    `scope` was taken: a rematerialized region recomputes in the backward,
    outside the forward's `ray_split_region`, and must reduce over the same
    group as its first run did."""
    global _ACTIVE, _RAY_REGION
    previous = _ACTIVE, _RAY_REGION
    _ACTIVE, _RAY_REGION = scope
    try:
        yield
    finally:
        _ACTIVE, _RAY_REGION = previous


def ray_split(total: int) -> Optional[Tuple[int, int]]:
    """[start, stop) of this rank's rays of `total` under an active mesh
    with a rays axis (ValueError where they do not divide), else None."""
    mesh = _ACTIVE
    if mesh is None or mesh.rays <= 1:
        return None
    if total % mesh.rays:
        raise ValueError(f"{total} sampled rays do not divide over the rays axis ({mesh.rays}) of the mesh")
    local = total // mesh.rays
    return mesh.rays_index * local, (mesh.rays_index + 1) * local


class _GatherRays(torch.autograd.Function):
    """The full ray axis from every rank's slice: an all-reduce over the rays
    group of a zero-filled full-length buffer in which each rank wrote its
    slice (gloo has no all-gather of CUDA tensors). The backward is the
    same all-reduce of the gradient, cut to the slice."""

    @staticmethod
    def forward(ctx, x, axis, start, total, group):
        import torch.distributed as dist

        ctx.axis, ctx.start, ctx.length, ctx.group = axis, start, x.shape[axis], group
        shape = list(x.shape)
        shape[axis] = total
        full = x.new_zeros(shape)
        full.narrow(axis, start, x.shape[axis]).copy_(x)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.axis, ctx.start, ctx.length), None, None, None, None


def gather_rays(tree: Any, axis: int, start: int, stop: int, total: int) -> Any:
    """Every per-ray tensor of a (nested dict of) render result(s), its ray
    axis `axis` gathered from this rank's rays [start, stop) to `total` over
    the active mesh's rays group; leaves with fewer axes are returned as
    they are, a leaf whose axis is not the slice's raises."""
    if isinstance(tree, dict):
        return {k: gather_rays(v, axis, start, stop, total) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_rays(v, axis, start, stop, total) for v in tree)
    if not torch.is_tensor(tree) or tree.dim() <= axis:
        return tree
    if tree.shape[axis] != stop - start:
        raise ValueError(f"a render output of shape {tuple(tree.shape)} has no ray axis {axis} of the slice's "
                         f"{stop - start} rays")
    return _GatherRays.apply(tree, axis, start, total, _ACTIVE.rays_group)


# ---------------------------------------------------------------------------
# The eval ray split's device mesh (one process, several devices)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeviceMesh:
    """A (data, rays) grid of devices driven by one process: the eval ray
    split renders the ray slice k of the batch rows of d on device
    `devices[d * rays + k]` (render/fast.py::render_rays_fast_sharded). A
    device may appear more than once."""

    devices: Tuple[torch.device, ...]
    data: int
    rays: int

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, RAYS_AXIS: self.rays}

    def device(self, data_index: int, rays_index: int) -> torch.device:
        return self.devices[data_index * self.rays + rays_index]


def create_device_mesh(devices: Iterable, data: int = 0) -> DeviceMesh:
    """The (data, rays) grid over `devices` (0: every device on data, rays
    1), row-major as the JAX package's create_2d_mesh reshapes them."""
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if data <= 0:
        data = n
    if n % data:
        raise ValueError(f"{n} devices not divisible by data={data}")
    return DeviceMesh(devices, data, n // data)


def local_devices(device) -> List[torch.device]:
    """The devices one process can render on: every visible card for a CUDA
    `device`, the CPU alone for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]
