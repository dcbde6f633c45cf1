"""The port's eval ray split (render/fast.py::render_rays_fast_sharded over a
parallel.mesh.DeviceMesh of CPU devices) against the JAX package's
FrameRenderer(mesh=...) on the virtual 8-device CPU mesh, on the scene of
tests/test_mesh_sharding.py's `renderer_setup` (tiny_scene over a 16x24
synthetic dataset, batch 2; its variables' shapes from jax.eval_shape of
the same init, values seeded with numpy, as test_torch_port_phase3.py's
`seeded_tree` makes them, so that no JAX init compiles), the weights
carried over by compat/from_flax.py and both renderers fed JAX's scene
encoding: frames at atol 1e-5, as the JAX test holds its split against its
unsplit render.

- rays 2 (data 1) and rays 4 (data 2: the batch split too);
- 15x17 frames (255 rays) over rays 4 and 8: the unit-z padding;
- a batch that does not divide the data axis warns, as JAX's does.
The split frames also equal the port's unsplit frames at 1e-5, and each
slice is one grouped MLP call (`fused_object_field_eval_group`).
"""

import os

import jax
import numpy as np
import pytest
import torch

from playableenvironments_tpu.eval.creators import FrameRenderer as JaxFrameRenderer
from playableenvironments_tpu.parallel import create_2d_mesh
from playableenvironments_tpu_torch.compat.from_flax import load_environment_model
from playableenvironments_tpu_torch.eval.creators import FrameRenderer
from playableenvironments_tpu_torch.ops import fused_nerf
from playableenvironments_tpu_torch.parallel.mesh import create_device_mesh
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from test_torch_port_phase3 import seeded_tree
from test_torch_port_train import to_port
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)


@pytest.fixture(scope="module")
def renderer_setup(tmp_path_factory):
    """(JAX model, seeded variables, batch) of test_mesh_sharding.py's scene."""
    from test_environment_model import RNGS, tiny_scene

    from playableenvironments_tpu.data.dataset import MulticameraVideoDataset
    from playableenvironments_tpu.data.synthetic import make_synthetic_dataset
    from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel

    root = make_synthetic_dataset(str(tmp_path_factory.mktemp("meshds")), videos=1, frames=4, height=16, width=24)
    batch = next(MulticameraVideoDataset(os.path.join(root, "test"), observations_count=1).iterate_batches(
        batch_size=2, shuffle=False))
    model = JaxEnvironmentModel(tiny_scene())
    shapes = jax.eval_shape(lambda: model.init(RNGS, *batch.environment_model_args(), samples_per_image=8))
    rng = np.random.default_rng(0)
    return model, {kind: seeded_tree(shapes[kind], rng) for kind in ("params", "batch_stats")}, batch


@pytest.fixture(scope="module")
def port_model(renderer_setup):
    model, variables, _ = renderer_setup
    port = EnvironmentModel(to_port(model.scene), device="cpu")
    load_environment_model(port, jax.device_get(variables))
    return port.eval()


@pytest.fixture(scope="module")
def encoding(renderer_setup):
    model, variables, batch = renderer_setup
    return JaxFrameRenderer(model, variables, image_size=(16, 24)).encode(batch)


def port_encoding(encoding):
    return SceneEncoding(**{name: torch.from_numpy(np.array(getattr(encoding, name)))
                            for name in SceneEncoding.__dataclass_fields__})


@pytest.mark.parametrize("image_size,data,rays", [((16, 24), 1, 2), ((16, 24), 2, 4), ((15, 17), 1, 4),
                                                  ((15, 17), 1, 8)])
def test_split_frames_match_jax_mesh_render(renderer_setup, port_model, encoding, image_size, data,
                                            rays):
    model, variables, _ = renderer_setup
    jax_mesh = create_2d_mesh(jax.devices()[: data * rays], data=data)
    reference = np.asarray(JaxFrameRenderer(model, variables, image_size=image_size, mesh=jax_mesh).render(encoding))
    mesh = create_device_mesh(["cpu"] * (data * rays), data=data)
    assert mesh.shape == {"data": data, "rays": rays}
    calls = []
    group = fused_nerf.fused_object_field_eval_group

    def counted(*args, **kwargs):
        calls.append(1)
        return group(*args, **kwargs)

    fused_nerf.fused_object_field_eval_group = counted
    try:
        split = FrameRenderer(port_model, None, image_size, mesh=mesh).render(port_encoding(encoding))
    finally:
        fused_nerf.fused_object_field_eval_group = group
    unsplit = FrameRenderer(port_model, None, image_size).render(port_encoding(encoding))
    assert split.shape == unsplit.shape == reference.shape
    # One grouped call a NeRF configuration a slice (tiny_scene's two objects share none).
    assert len(calls) == data * rays * len({om.nerf for om in port_model.scene.object_models})
    np.testing.assert_allclose(split.numpy(), reference, atol=1e-5, rtol=0)
    np.testing.assert_allclose(split.numpy(), unsplit.numpy(), atol=1e-5, rtol=0)


def test_a_batch_that_does_not_divide_the_data_axis_warns(port_model, encoding):
    mesh = create_device_mesh(["cpu"] * 8, data=4)  # batch 2 % data 4 != 0
    unsplit = FrameRenderer(port_model, None, (16, 24)).render(port_encoding(encoding))
    with pytest.warns(UserWarning, match="replicated"):
        split = FrameRenderer(port_model, None, (16, 24), mesh=mesh).render(port_encoding(encoding))
    np.testing.assert_allclose(split.numpy(), unsplit.numpy(), atol=1e-5, rtol=0)
