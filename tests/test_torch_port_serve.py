"""Serving artifacts of the port (serve.py, cli/export_renderer.py) on the
CPU, the analogue of tests/test_serve.py, on configs/synthetic_smoke.yaml
with seeded phase-2 and phase-3 checkpoints over data.synthetic's dataset:

- `cli.export_renderer --playable_checkpoint ... --platforms cpu` writes
  the render, step0 and step artifacts; loaded, the render artifact's
  frames equal the live FrameRenderer's bit for bit (the same plain B1 and
  operations), and the interactive loop (render, step0, step, step) equals
  the live `interactive_step` and render bit for bit;
- the render graph calls B1 as its registered operator;
- a generic function round-trips, and its header has the JAX package's
  fields with the same values as a JAX artifact of the same function
  (JAX serve.py:57-72: format_version, name, platforms, in_avals,
  out_avals);
- the version gate: an artifact of another format version raises; an
  artifact asked for another platform than its inputs' raises;
- the operator's fake implementation gives the plain version's shapes and
  dtypes.
Exact checks; no tolerance.
"""

import importlib
import os
import struct
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from playableenvironments_tpu import serve as jax_serve
from playableenvironments_tpu_torch import serve
from playableenvironments_tpu_torch.cli import common
from playableenvironments_tpu_torch.config import ObjectIds
from playableenvironments_tpu_torch.cli.generate_reconstructed_dataset import build_renderer
from playableenvironments_tpu_torch.data.synthetic import make_synthetic_dataset
from playableenvironments_tpu_torch.ops import fused_nerf
from playableenvironments_tpu_torch.render.interactive import action_inputs, interactive_step
from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
from playableenvironments_tpu_torch.train import checkpointing
from playableenvironments_tpu_torch.train.trainer_playable import PlayableTrainer, PlayableTrainingConfig
from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The seeded checkpoints and the CLI's interactive bundle."""
    root = str(tmp_path_factory.mktemp("port_serve"))
    make_synthetic_dataset(os.path.join(root, "data"), videos=1, frames=4, height=16, width=24, splits=("test",))
    with open(os.path.join(REPO, "configs", "synthetic_smoke.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["data_root"] = os.path.join(root, "data")
    cfg["logging"].update(output_root=os.path.join(root, "results"), checkpoints_root=os.path.join(root, "ckpt"))
    config = os.path.join(root, "smoke.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    cfg = common.load_yaml(config)
    model = common.build_environment_model(cfg, device="cpu", seed=3)
    environment = checkpointing.save_checkpoint(os.path.join(root, "phase2"),
                                                SynthesisTrainer(model, common.synthesis_training_config(cfg)))
    trainer = PlayableTrainer(PlayableEnvironmentModel(model.scene, device="cpu", seed=4), PlayableTrainingConfig(),
                              environment_model=model)
    trainer.init_extra(5)
    playable = checkpointing.save_checkpoint(os.path.join(root, "phase3"), trainer)
    argv = sys.argv
    sys.argv = ["export_renderer", "--config", config, "--checkpoint", environment, "--output",
                os.path.join(root, "bundle"), "--playable_checkpoint", playable, "--platforms", "cpu"]
    try:
        paths = importlib.import_module("playableenvironments_tpu_torch.cli.export_renderer").main()
    finally:
        sys.argv = argv
    return {"root": root, "cfg": cfg, "environment": environment, "playable": playable, "paths": paths}


@pytest.fixture(scope="module")
def live(exported):
    """The live renderer, its first test encoding and the restored playable model."""
    renderer, dataset, env_model = build_renderer(exported["cfg"], exported["environment"], "cpu")
    encoding = renderer.encode(next(dataset.iterate_batches(1, shuffle=False))).map(lambda x: x[:, :1])
    playable = PlayableEnvironmentModel(env_model.scene, device="cpu")
    checkpointing.restore_checkpoint(exported["playable"], PlayableTrainer(playable, PlayableTrainingConfig(),
                                                                           environment_model=env_model))
    return renderer, encoding, playable.eval()


def test_render_artifact_equals_the_live_render(exported, live):
    renderer, encoding, _ = live
    artifact = serve.load_artifact(exported["paths"]["render"])
    assert artifact.header["name"] == "render_16x24" and artifact.header["platforms"] == ["cpu"]
    assert artifact.header["out_avals"] == ["float32[1,1,1,16,24,3]"]
    frames = artifact(encoding)
    assert torch.equal(frames, renderer.render(encoding))
    assert float(frames.std()) > 0.0
    targets = {str(node.target) for node in artifact.program.graph.nodes if node.op == "call_function"}
    assert any("fused_adain_nerf_group" in t for t in targets), targets


def test_interactive_loop_equals_the_live_steps(exported, live):
    renderer, encoding, playable = live
    render, step0, step = (serve.load_artifact(exported["paths"][k]) for k in ("render", "step0", "step"))
    assert step0.header["name"] == "interactive_step0" and step.header["name"] == "interactive_step"
    initial_style = encoding.object_style
    live_encoding, served_encoding = encoding, encoding
    dynamic = ObjectIds(playable.scene).dynamic_objects_count
    carries, served_carries = [None] * dynamic, None
    frames = []
    for index, action in enumerate([0, 1, 2]):
        one_hots, variations = action_inputs(playable, [action] * dynamic, device="cpu")
        live_encoding, carries = interactive_step(playable, live_encoding, initial_style, carries, one_hots,
                                                  variations)
        if index == 0:
            served_encoding, served_carries = step0(served_encoding, initial_style, one_hots, variations)
        else:
            served_encoding, served_carries = step(served_encoding, initial_style, served_carries, one_hots,
                                                   variations)
        for name in ("object_rotations", "object_translations", "object_style", "object_deformation"):
            assert torch.equal(getattr(served_encoding, name), getattr(live_encoding, name)), (index, name)
        live_frame = renderer.render(live_encoding)
        assert torch.equal(render(served_encoding), live_frame)
        frames.append(live_frame)
    assert not torch.equal(frames[0], frames[2])


def test_generic_function_round_trip_and_header_match_a_jax_artifact(tmp_path):
    def fn(x, y):
        return x * y + 1.0, {"total": x.sum()}

    x, y = np.arange(6, dtype=np.float32).reshape(2, 3), np.full((2, 3), 0.5, np.float32)
    path = serve.export_function(fn, (torch.from_numpy(x), torch.from_numpy(y)), str(tmp_path / "fn.pexp"),
                                 name="fn")
    artifact = serve.load_artifact(path)
    product, extra = artifact(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.equal(product, torch.from_numpy(x * y + 1.0)) and float(extra["total"]) == 15.0
    jax_path = jax_serve.export_function(lambda a, b: (a * b + 1.0, {"total": a.sum()}),
                                         (jnp.asarray(x), jnp.asarray(y)), str(tmp_path / "fn_jax.pexp"), name="fn")
    jax_header = jax_serve.load_artifact(jax_path).header
    for key in jax_header:
        assert artifact.header[key] == jax_header[key], key


def test_the_version_gate_and_the_platform(tmp_path):
    path = serve.export_function(lambda x: x + 1.0, (torch.zeros(2),), str(tmp_path / "a.pexp"))
    blob = open(path, "rb").read()
    (head_len,) = struct.unpack("<I", blob[:4])
    head = blob[4 : 4 + head_len].replace(b'"format_version": 1', b'"format_version": 2')
    with open(tmp_path / "b.pexp", "wb") as f:
        f.write(struct.pack("<I", len(head)) + head + blob[4 + head_len:])
    with pytest.raises(ValueError, match="unsupported artifact format 2"):
        serve.load_artifact(str(tmp_path / "b.pexp"))
    with pytest.raises(ValueError, match="one platform|device type"):
        serve.export_function(lambda x: x + 1.0, (torch.zeros(2),), str(tmp_path / "c.pexp"), platforms=("cuda",))
    with pytest.raises(ValueError, match="device type"):
        serve.export_function(lambda x: x + 1.0, (torch.zeros(2),), str(tmp_path / "d.pexp"),
                              platforms=("cpu", "cuda"))


def test_the_fake_operator_gives_the_plain_shapes():
    """B1's registered operator under fake tensors (what torch.export
    traces) against its CPU implementation on real ones."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from playableenvironments_tpu_torch.config import NerfMLPConfig, PositionalEncoderConfig

    cfg = NerfMLPConfig(layers_width=32, backbone_layers_count=4, skip_layer_idx=2, output_features=5,
                        position_encoder=PositionalEncoderConfig(octaves=2))
    gen = torch.Generator().manual_seed(0)
    pe = 3 + 3 * 2 * 2
    sizes = [(pe if i == 0 else 32 + (pe if i == 2 else 0), 32) for i in range(4)]
    packed = {f"w{i}": torch.randn(s, generator=gen) for i, s in enumerate(sizes)}
    packed.update({f"b{i}": torch.randn(32, generator=gen) for i in range(4)})
    packed.update(w_alpha=torch.randn(32, 1, generator=gen), b_alpha=torch.randn(1, generator=gen),
                  w_f0=torch.randn(32, 32, generator=gen), w_f1=torch.randn(32, 16, generator=gen),
                  w_out=torch.randn(16, 5, generator=gen), b_out=torch.randn(5, generator=gen))
    weights = fused_nerf.kernel_weights(cfg, packed)

    def items(n_points):
        return [fused_nerf.AdaInNerfItem(weights, torch.randn(n, pe, generator=gen), torch.randn(n // 4, 32),
                                         torch.randn(n // 4, 32), torch.randn(n // 4, 16), torch.randn(n // 4, 16), 4)
                for n in n_points]

    real = fused_nerf.fused_adain_nerf_group(cfg, items([8, 0, 12]))
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_items = [it._replace(encoded=mode.from_tensor(it.encoded)) for it in items([8, 0, 12])]
        fake = fused_nerf.fused_adain_nerf_group(cfg, fake_items)
    assert [(f.shape, f.dtype, a.shape, a.dtype) for f, a in fake] == [
        (f.shape, f.dtype, a.shape, a.dtype) for f, a in real]
    assert [tuple(f.shape) for f, _ in real] == [(8, 5), (0, 5), (12, 5)]
