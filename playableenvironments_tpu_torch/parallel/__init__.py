"""Data and ray parallelism over processes, and the eval ray split's device
mesh (parallel/mesh.py)."""

from playableenvironments_tpu_torch.parallel.mesh import (
    DeviceMesh,
    Mesh,
    active_mesh,
    compile_barrier,
    create_2d_mesh,
    create_device_mesh,
    create_mesh,
    maybe_initialize_distributed,
    process_group,
    replicate,
    shard_batch,
    verify_replication,
)
