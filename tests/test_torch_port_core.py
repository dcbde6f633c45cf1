"""The PyTorch port's geometry, encoding, sampling and config code against
the JAX package, on the same seeded numpy inputs (f32, atol=rtol=1e-5).
Also: the port imports no JAX and sets no global TF32 flag."""

import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.core import bbox as jbbox
from playableenvironments_tpu.core import compositing as jcompositing
from playableenvironments_tpu.core import rays as jrays
from playableenvironments_tpu.core import transforms3d as jtransforms
from playableenvironments_tpu.models import encoding as jencoding
from playableenvironments_tpu.models import layers as jlayers
from playableenvironments_tpu.render import sampling as jsampling
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.core import bbox, compositing, rays, transforms3d
from playableenvironments_tpu_torch.models import encoding, layers
from playableenvironments_tpu_torch.render import sampling
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-5, rtol=1e-5)


def close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.mark.parametrize("name", ["tennis.yaml", "minecraft.yaml", "synthetic_smoke.yaml"])
def test_config_copy_reads_yaml_like_the_jax_package(name):
    path = str(REPO / "configs" / name)
    assert dataclasses.asdict(port_config.scene_from_yaml(path)) == dataclasses.asdict(
        jax_config.scene_from_yaml(path)
    )


def test_object_ids_match():
    scene_path = str(REPO / "configs" / "tennis.yaml")
    port = port_config.ObjectIds(port_config.scene_from_yaml(scene_path))
    ref = jax_config.ObjectIds(jax_config.scene_from_yaml(scene_path))
    assert vars(port) == vars(ref)


@pytest.mark.parametrize("fn", ["rotation_x", "rotation_y", "rotation_z"])
def test_rotations(rng, fn):
    angles = rng.uniform(-np.pi, np.pi, (5, 2)).astype(np.float32)
    close(getattr(transforms3d, fn)(t(angles)), getattr(jtransforms, fn)(jnp.asarray(angles)))


def test_euler_matrix_and_rigid_inverse(rng):
    rot = rng.uniform(-np.pi, np.pi, (4, 3, 3)).astype(np.float32)
    trans = rng.normal(size=(4, 3, 3)).astype(np.float32) * 5
    port = transforms3d.euler_translation_to_matrix(t(rot), t(trans))
    ref = jtransforms.euler_translation_to_matrix(jnp.asarray(rot), jnp.asarray(trans))
    close(port, ref)
    close(transforms3d.invert_rigid(port), jtransforms.invert_rigid(ref))


def test_camera_rays(rng):
    focals = rng.uniform(20, 60, (2, 1, 3)).astype(np.float32)
    for port, ref in zip(rays.camera_rays(6, 10, t(focals)), jrays.camera_rays(6, 10, jnp.asarray(focals))):
        close(port, ref)


def test_transform_points_and_rays(rng):
    m = np.asarray(
        jtransforms.euler_translation_to_matrix(
            jnp.asarray(rng.uniform(-1, 1, (2, 3)), jnp.float32),
            jnp.asarray(rng.normal(size=(2, 3)), jnp.float32),
        )
    )
    origins = rng.normal(size=(2, 3)).astype(np.float32)
    dirs = rng.normal(size=(2, 7, 3)).astype(np.float32)
    normals = rng.normal(size=(2, 3)).astype(np.float32)
    for translate in (True, False):
        close(
            rays.transform_points(t(origins), t(m), translate=translate),
            jrays.transform_points(jnp.asarray(origins), jnp.asarray(m), translate=translate),
        )
    port = rays.transform_rays(t(origins), t(dirs), t(normals), t(m))
    ref = jrays.transform_rays(*map(jnp.asarray, (origins, dirs, normals, m)))
    for p, r in zip(port, ref):
        close(p, r)


def test_aabb_and_ray_bounds(rng):
    box = np.asarray([[-1.0, 1.0], [-0.5, 0.5], [0.0, 2.0]], np.float32)
    points = rng.uniform(-1.5, 2.5, (50, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        bbox.aabb_contains(t(box), t(points)).numpy(),
        np.asarray(jbbox.aabb_contains(jnp.asarray(box), jnp.asarray(points))),
    )
    close(bbox.aabb_size(t(box)), jbbox.aabb_size(jnp.asarray(box)))
    origins = rng.normal(size=(3, 3)).astype(np.float32) * 4
    dirs = rng.normal(size=(3, 40, 3)).astype(np.float32)
    dirs[0, 0] = [0.0, 0.0, 1.0]  # axis-parallel: the eps denominator matters
    validity = np.asarray([True, True, False])
    port = bbox.ray_aabb_bounds(t(origins), t(dirs), t(box), torch.from_numpy(validity))
    ref = jbbox.ray_aabb_bounds(*map(jnp.asarray, (origins, dirs, box, validity)))
    for p, r in zip(port, ref):
        close(p, r, atol=1e-4, rtol=1e-5)
    # Missed and invalid rays collapse to z_near = z_far = 0.
    assert (port[0][2] == 0).all() and (port[1][2] == 0).all()
    missed = port[1] <= port[0]
    assert missed.any() and (port[0][missed] == 0).all()


def test_compositing_weights(rng):
    alphas = rng.uniform(0, 1, (4, 9)).astype(np.float32)
    close(compositing.compositing_weights(t(alphas)), jcompositing.compositing_weights(jnp.asarray(alphas)))


@pytest.mark.parametrize("weighted", [False, True])
def test_positional_encoding_and_annealing(rng, weighted):
    x = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    for step in (0, 37, 150):
        close(encoding.annealing_weights(4, step, 100), jencoding.annealing_weights(4, step, 100))
    w = encoding.annealing_weights(4, 37, 100) if weighted else None
    jw = jencoding.annealing_weights(4, 37, 100) if weighted else None
    close(
        encoding.positional_encoding(t(x), 4, True, w),
        jencoding.positional_encoding(jnp.asarray(x), 4, True, jw),
    )


def test_rotation_encoding(rng):
    angles = rng.uniform(-3, 3, (4, 3)).astype(np.float32)
    encoded = layers.encode_rotation(t(angles))
    close(encoded, jlayers.encode_rotation(jnp.asarray(angles)))
    close(layers.decode_rotation(encoded), jlayers.decode_rotation(jnp.asarray(encoded.numpy())))


def test_strided_grid_sampling(rng):
    dirs = rng.normal(size=(1, 1, 2, 16, 24, 3)).astype(np.float32)
    obs = rng.normal(size=dirs.shape).astype(np.float32)
    port = sampling.sample_all_rays_strided_grid(t(dirs), t(obs), [2, 4])
    ref = jsampling.sample_all_rays_strided_grid(jnp.asarray(dirs), jnp.asarray(obs), [2, 4])
    for p, r in zip(port, ref):
        close(p, r)
    feats = rng.normal(size=(1, 1, 2, port[0].shape[-2], 5)).astype(np.float32)
    for p, r in zip(
        sampling.split_strided_grid_samples(t(feats), [2, 4], (16, 24)),
        jsampling.split_strided_grid_samples(jnp.asarray(feats), [2, 4], (16, 24)),
    ):
        close(p, r)


def _port_sources():
    root = REPO / "playableenvironments_tpu_torch"
    return sorted(root.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "tests" / "torch_port_reference_layout.py"]


def test_port_imports_no_jax():
    """No file of the port, nor chip_smoke.py or the reference-layout helper
    it imports, imports jax, flax or the JAX package (importlib and
    __import__ by name included)."""
    banned = ("jax", "flax", "playableenvironments_tpu")
    offenders = []
    for path in _port_sources():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__",
            ):
                names = [a.value for a in node.args if isinstance(a, ast.Constant)]
            for name in names:
                if name.split(".")[0] in banned:
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    names = {str(path.relative_to(REPO)) for path in _port_sources()}
    for module in ("ops/fused_nerf.py", "ops/roi_crop.py", "models/object_encoders.py",
                   "models/parameter_encoders.py", "render/environment_model.py", "data/batching.py",
                   "train/losses.py", "train/state.py", "train/trainer_synthesis.py", "utils/random.py",
                   "ops/fused_rollout.py", "models/action.py", "models/discriminator.py",
                   "render/playable_model.py", "train/trainer_playable.py", "data/video.py",
                   "data/native_loader.py", "data/synthetic.py", "data/dataset.py", "cli/common.py",
                   "eval/creators.py", "train/encoding_cache.py", "utils/remat.py", "utils/meters.py",
                   "utils/logger.py", "utils/video_io.py", "eval/training_evaluator.py",
                   "eval/autoencoder_evaluator.py", "eval/action_modifiers.py", "eval/playable_evaluator.py",
                   "cli/train.py", "cli/train_autoencoder.py", "cli/train_playable.py", "cli/play.py",
                   "cli/import_checkpoint.py", "compat/torch_import.py", "train/checkpointing.py",
                   "eval/metrics.py", "eval/distribution_metrics.py", "eval/inception_v3.py", "eval/evaluators.py",
                   "eval/plotting.py", "cli/generate_reconstructed_dataset.py",
                   "cli/generate_reconstructed_camera_manipulation_dataset.py",
                   "cli/generate_reconstructed_playability_dataset.py", "cli/evaluate_reconstructed_dataset.py",
                   "cli/evaluate_reconstructed_camera_manipulation_dataset.py",
                   "cli/evaluate_reconstructed_playability_dataset.py", "cli/evaluate_fvd_reconstructed_dataset.py",
                   "cli/fid.py"):
        assert f"playableenvironments_tpu_torch/{module}" in names, module
    assert len(names) > 30
    assert not offenders, offenders


def test_port_leaves_tf32_flags_alone():
    """The port states its float32 precision by leaving PyTorch's defaults
    (f32 matmuls in full precision; f32 convolutions in TF32 on a card, as
    cuDNN decides): no source assigns a TF32 switch or calls
    set_float32_matmul_precision, and rendering changes none of them."""
    switches = ("allow_tf32", "allow_bf16_reduced_precision_reduction", "allow_fp16_reduced_precision_reduction")
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            targets = node.targets if isinstance(node, ast.Assign) else (
                [node.target] if isinstance(node, (ast.AugAssign, ast.AnnAssign)) else [])
            for target in targets:
                assert getattr(target, "attr", None) not in switches, f"{path}:{node.lineno}"
            if isinstance(node, ast.Call):
                assert getattr(node.func, "attr", None) != "set_float32_matmul_precision", f"{path}:{node.lineno}"

    def flags():
        return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                torch.get_float32_matmul_precision())

    before = flags()
    from playableenvironments_tpu_torch.config import AutoencoderConfig
    from playableenvironments_tpu_torch.models.autoencoder import MultiresAutoencoder

    ae = MultiresAutoencoder(AutoencoderConfig(bottleneck_features=16, bottleneck_blocks=1,
                                               downsampling_layers_count=(1, 1)), device="cpu")
    ae.decode([torch.zeros(1, 4, 6, 8), torch.zeros(1, 2, 3, 16)])
    assert flags() == before


def test_entry_points_default_to_the_card():
    """Without a card the default device raises instead of falling back."""
    from playableenvironments_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"
