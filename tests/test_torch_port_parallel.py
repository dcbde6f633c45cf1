"""Data and ray parallelism of the port (parallel/mesh.py) on the CPU: two
gloo ranks (tests/torch_port_ranks.py, processes that import no JAX)
against the one-process step of the same global batch.

- one phase-2 step on tests/test_torch_port_train.py's tiny scene and batch
  (B 2: one example a rank) with perturbation, the style shuffle and
  weighted ray sampling on, so that every draw is sliced
  (`ShardedStreams`), the encoders' batch norms and the NeRFs' AdaIN norms
  see the global batch and the masked losses its counts; the same step
  with `remat` on a data 1 x rays 2 mesh (each rank renders half of the
  sampled rays, drawing its slice of the whole render's draws; the outputs
  gathered; the recomputed regions reduce over their first run's group);
- one phase-1 step (tests/test_torch_port_phase1.py's tiny autoencoder, 4
  images: 2 a rank);
- one phase-3 fused step (tests/test_torch_port_phase3.py's two-player
  scene and encoding, batch 4: 2 a rank) with the GAN, ACMV and entropy
  losses, so that the mutual information's joint probabilities, ACMV's
  moments and the centroid update are the global batch's.
Every rank's loss and metrics within 2e-4 relative of the one-process
step's, every gradient within GRAD_BOUND of its tensor's largest magnitude
plus MODEL_BOUND of its model's largest (a bias before a batch norm has a
noise-only gradient, 1e-8 to 1e-11 here), the running statistics,
centroids and MI matrices within 1e-5, the parameters after Adam's first
step within 1e-5 where the gradient is clear (above 1e-3 of its tensor's
largest and twice its bound) and 2 lr everywhere (lr * sign(g) flips where g sits at the level
of the summation noise), and both ranks' states equal bit for bit. The two
processes sum in another order than one (per-rank sums, then gloo's
all-reduce); measured, the largest gradient differences are 1.06e-4 of
the tensor's largest in phase 2 (the player encoder's first convolution,
under eleven batch norms; the one-process step's own distance from JAX's
is held at 1e-4 for the same reason), 7.6e-6 in phase 1 and 2.3e-6 in
phase 3, with metrics within 5.8e-5; so GRAD_BOUND = 5e-4 and MODEL_BOUND
= 1e-5.

Also: the phase-2 CLI over two ranks (rank 0 alone writes the
checkpoints), resumed, equals the uninterrupted two-rank run bit for bit;
`verify_replication` raises on every rank when one rank's state differs,
and passes after `replicate`; `build_training_mesh` raises where the JAX
package's does (tests/test_mesh_sharding.py:197-276), in one process and
in two. Each launch kills its ranks and fails after its timeout.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

import torch_port_ranks
from playableenvironments_tpu_torch.cli.common import build_training_mesh
from playableenvironments_tpu_torch.data.batching import Batch
from playableenvironments_tpu_torch.models.autoencoder import MultiresAutoencoder
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.train import checkpointing, trainer_autoencoder, trainer_playable
from playableenvironments_tpu_torch.train import trainer_synthesis
from playableenvironments_tpu_torch.utils.random import RngStreams
from test_torch_port_phase1 import AE
from test_torch_port_phase3 import encoding_arrays
from test_torch_port_phase3 import scene as phase3_scene
from test_torch_port_phase3 import training_config as phase3_config
from test_torch_port_train import FIRST_STEP, WEIGHTS, batch_arrays, fused_scene, to_port
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

GRAD_BOUND = 5e-4
MODEL_BOUND = 1e-5
LR = 5e-4
MESH_CASES = [  # (name, training.mesh, batch size), run in two processes
    ("default", {}, 2), ("default_odd", {}, 3), ("rays_only", {"rays": 2}, 2), ("too_many", {"data": 2, "rays": 2}, 2),
    ("data_subset", {"data": 1}, 2), ("indivisible", {"data": 2}, 3), ("data_2", {"data": 2}, 4),
]


def phase2_config():
    return trainer_synthesis.SynthesisTrainingConfig(
        samples_per_image=48, perturb=True, shuffle_style=True, max_steps=4, learning_rate=LR,
        loss_weights=trainer_synthesis.LossWeights(**WEIGHTS),
    )


def cli_runs(root):
    """The phase-2 CLI's command lines on two ranks: 3 steps uninterrupted;
    2 steps, then resumed to 3. :return: (command lines, checkpoint dirs)."""
    from playableenvironments_tpu_torch.data.synthetic import make_synthetic_dataset

    make_synthetic_dataset(os.path.join(root, "data"), videos=1, frames=11, height=16, width=24)
    with open(os.path.join(torch_port_ranks.REPO, "configs", "synthetic_smoke.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["data_root"] = os.path.join(root, "data")
    cfg["logging"].update(output_root=os.path.join(root, "results"), checkpoints_root=os.path.join(root, "ckpt"))
    cfg["training"].update(max_steps=3, save_freq=2, log_interval_steps=1, quick_save_freq=100)
    cfg["training"]["batching"]["batch_size"] = 2
    argvs = []
    for name, steps in (("whole", [3]), ("resumed", [2, 3])):
        path = os.path.join(root, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump({**cfg, "logging": {**cfg["logging"], "run_name": name}}, f)
        argvs += [["--config", path, "--max_steps", str(max_steps), "--device", "cpu"] for max_steps in steps]
    return argvs, {name: os.path.join(root, "ckpt", name) for name in ("whole", "resumed")}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("ranks"))
    argvs, checkpoints = cli_runs(directory)
    scene = to_port(fused_scene())
    assert scene.use_weighted_sampling
    # The player's crop raised as test_torch_port_train.py raises the
    # background's: at 8x16 its last blocks normalize 4 values a channel,
    # which amplifies f32 summation noise ~1e3.
    scene = dataclasses.replace(scene, object_encoders=scene.object_encoders[:1] + (
        dataclasses.replace(scene.object_encoders[1], input_size=(32, 64)),))
    model = EnvironmentModel(scene, device="cpu", seed=3)
    ae_cfg = port_config.AutoencoderConfig(**AE)
    ae = MultiresAutoencoder(ae_cfg, device="cpu")
    p3_scene = to_port(phase3_scene())
    playable = PlayableEnvironmentModel(p3_scene, with_discriminators=True, device="cpu", seed=5)
    p3_trainer = trainer_playable.PlayableTrainer(playable, phase3_config(trainer_playable))
    p3_trainer.init_extra(5)
    data = {
        "phase2": {"scene": scene, "state": model.state_dict(), "config": phase2_config(), "first_step": FIRST_STEP,
                   "batch": Batch(**{k: torch.from_numpy(v) for k, v in batch_arrays().items()})},
        "phase1": {"autoencoder": ae_cfg, "state": ae.state_dict(),
                   "config": trainer_autoencoder.AutoencoderTrainingConfig(learning_rate=4e-4, kl_lambda=5e-6),
                   "images": torch.from_numpy(np.random.default_rng(7).random((4, 32, 32, 3)).astype(np.float32))},
        "phase3": {"scene": p3_scene, "state": playable.state_dict(), "config": phase3_config(trainer_playable),
                   "centroids": p3_trainer.centroids, "mi_matrices": p3_trainer.mi_matrices,
                   "encoding": SceneEncoding(**{k: torch.from_numpy(v) for k, v in encoding_arrays().items()})},
        "mesh_cases": MESH_CASES,
        "cli_runs": argvs,
        "checkpoints": checkpoints,
    }
    torch.save(data, os.path.join(directory, "inputs.pt"))
    return directory, data


@pytest.fixture(scope="module")
def ranks(inputs):
    directory, _ = inputs
    return torch_port_ranks.launch("steps", directory)


def close_metrics(got, ref):
    assert set(got) == set(ref)
    for name in ref:
        torch.testing.assert_close(got[name], ref[name], rtol=2e-4, atol=1e-7, msg=name)


def tolerances(grads):
    """Each gradient's bound: GRAD_BOUND of its largest plus MODEL_BOUND of
    its model's (top-level module's) largest."""
    models = {}
    for name, g in grads.items():
        models[name.split(".")[0]] = max(models.get(name.split(".")[0], 0.0), float(g.abs().max()))
    return {name: GRAD_BOUND * float(g.abs().max()) + MODEL_BOUND * models[name.split(".")[0]]
            for name, g in grads.items()}


def close_grads(got, ref):
    for name, bound in tolerances(ref).items():
        err = float((got[name] - ref[name]).abs().max())
        assert err <= bound, (name, err, bound)


def close_state(got, ref, grads):
    bounds = tolerances(grads)
    for name, value in ref.items():
        if name in grads:
            g = grads[name].abs()
            clear = (g > 1e-3 * float(g.max())) & (g > 2 * bounds[name])
            err = (got[name] - value).abs()
            assert not bool(clear.any()) or float(err[clear].max()) <= 1e-5, name
            assert float(err.max()) <= 2 * LR + 1e-6, name
        elif value.is_floating_point():
            torch.testing.assert_close(got[name], value, rtol=1e-5, atol=1e-5, msg=name)
        else:
            assert torch.equal(got[name], value), name


def check_ranks(ranks, key, ref):
    metrics, grads, state = ref
    for out in ranks:
        close_metrics(out[key][0], metrics)
        close_grads(out[key][1], grads)
        close_state(out[key][2], state, grads)
    for name, value in ranks[0][key][2].items():
        assert torch.equal(value, ranks[1][key][2][name]), name


def test_two_ranks_take_the_one_process_phase2_step(inputs, ranks):
    _, data = inputs
    assert [out["mesh"]["data"] for out in ranks] == [({"data": 2, "rays": 1}, r, 0) for r in (0, 1)]
    ref = torch_port_ranks.phase2_step(data, None, data["phase2"]["batch"], RngStreams(0, "cpu"))
    check_ranks(ranks, "phase2", ref)


def test_a_rays_mesh_takes_the_one_process_phase2_step(inputs, ranks):
    """data 1 x rays 2, with `remat`: each rank renders 48 of the 96 sampled
    rays an image, and its rematerialized regions recompute over the group
    of their first run."""
    _, data = inputs
    assert [out["mesh"]["rays"] for out in ranks] == [({"data": 1, "rays": 2}, 0, r) for r in (0, 1)]
    ref = torch_port_ranks.phase2_step(data, None, data["phase2"]["batch"], RngStreams(0, "cpu"), remat=True)
    check_ranks(ranks, "phase2_rays", ref)


def test_two_ranks_take_the_one_process_phase1_step(inputs, ranks):
    _, data = inputs
    ref = torch_port_ranks.phase1_step(data, None, data["phase1"]["images"], RngStreams(0, "cpu"))
    check_ranks(ranks, "phase1", ref)


def test_two_ranks_take_the_one_process_phase3_step(inputs, ranks):
    _, data = inputs
    metrics, grads, after = torch_port_ranks.phase3_step(data, None, data["phase3"]["encoding"],
                                                         RngStreams(0, "cpu"))
    for out in ranks:
        got_metrics, got_grads, got_after = out["phase3"]
        close_metrics(got_metrics, metrics)
        close_grads(got_grads, grads)
        close_state(got_after["state"], after["state"], grads)
        for key in ("centroids", "mi_matrices"):
            for a, b in zip(got_after[key], after[key]):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=key)
    for name, value in ranks[0]["phase3"][2]["state"].items():
        assert torch.equal(value, ranks[1]["phase3"][2]["state"][name]), name


def test_verify_replication_raises_on_a_perturbed_rank(ranks):
    for out in ranks:
        assert "state differs across processes" in out["verify"] and "PE_VERIFY_REPLICATION" in out["verify"]


def test_build_training_mesh_validation(ranks):
    """The JAX package's rules, one process a device: in two processes."""
    for out in ranks:
        cases = out["mesh_cases"]
        assert cases["default"] == ({"data": 2, "rays": 1}, False)
        assert cases["rays_only"] == ({"data": 1, "rays": 2}, True)
        assert cases["data_2"] == ({"data": 2, "rays": 1}, False)
        assert "divide" in cases["default_odd"] and "divide" in cases["indivisible"]
        assert "devices" in cases["too_many"] and "torchrun" in cases["too_many"]
        assert "must use all 2 devices" in cases["data_subset"]
    # In one process, as tests/test_mesh_sharding.py's single-host cases.
    mesh, is_2d = build_training_mesh({"training": {}}, batch_size=2, device="cpu")
    assert not is_2d and mesh.shape == {"data": 1, "rays": 1}
    with pytest.raises(ValueError, match="devices"):
        build_training_mesh({"training": {"mesh": {"data": 4, "rays": 2}}}, batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="exceeds 1 devices"):
        build_training_mesh({"training": {"mesh": {"data": 4}}}, batch_size=3, device="cpu")


def test_two_rank_cli_saves_once_and_resumes_bit_for_bit(inputs, ranks):
    root, data = inputs
    runs = data["checkpoints"]
    assert sorted(os.listdir(runs["whole"])) == ["checkpoint_2", "checkpoint_3"]
    whole = checkpointing.saved_flat_state(os.path.join(runs["whole"], "checkpoint_3"))
    resumed = checkpointing.saved_flat_state(os.path.join(runs["resumed"], "checkpoint_3"))
    assert checkpointing.state_difference(resumed, whole) is None
    for name in ("whole", "resumed"):
        results = os.path.join(root, "results", name)
        with open(os.path.join(results, "metrics.jsonl")) as f:
            steps = [int(line.split('"step": ')[1].split(",")[0]) for line in f]
        assert steps == [1, 2, 3]
        timing = [n for n in os.listdir(results) if n.startswith("timing_train")]
        assert sorted(timing) == ["timing_train.json", "timing_train.rank1.json"]


def test_distributed_switches_and_backends(monkeypatch):
    """PE_MULTIHOST reads "0"/"false"/"no" as off, as the JAX package's
    `_truthy`; a configured run without torchrun's variables raises naming
    torchrun; NCCL is refused for the CPU, and no backend is taken quietly
    for another."""
    from playableenvironments_tpu_torch.parallel import mesh as mesh_lib

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("PE_DIST_BACKEND", raising=False)
    for off in ("0", "false", "No", ""):
        monkeypatch.setenv("PE_MULTIHOST", off)
        assert not mesh_lib.distributed_configured()
        assert mesh_lib.maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("PE_MULTIHOST", "1")
    for name in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        mesh_lib.maybe_initialize_distributed("cpu")
    assert mesh_lib.select_backend(torch.device("cpu")) == "gloo"
    assert mesh_lib.select_backend(torch.device("cuda")) == "nccl"
    with pytest.raises(ValueError, match="gloo"):
        mesh_lib.select_backend(torch.device("cpu"), "nccl")
    monkeypatch.setenv("PE_DIST_BACKEND", "gloo")
    assert mesh_lib.select_backend(torch.device("cuda")) == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.rank_device("cuda", "nccl", 0)


def test_process_group_takes_down_only_the_group_it_brought_up(monkeypatch):
    """`mesh.process_group`, around each training CLI's run: a group it
    brought up (one gloo process, PE_MULTIHOST on) is destroyed when the run
    ends, so that no backend thread outlives the run into the interpreter's
    exit; a run that raises keeps it; a group that was up before is left
    up."""
    import torch.distributed as dist

    from playableenvironments_tpu_torch.parallel import mesh as mesh_lib

    assert not dist.is_initialized()
    monkeypatch.delenv("PE_DIST_BACKEND", raising=False)
    for name, value in (("PE_MULTIHOST", "1"), ("WORLD_SIZE", "1"), ("RANK", "0"), ("MASTER_ADDR", "127.0.0.1")):
        monkeypatch.setenv(name, value)
    try:
        monkeypatch.setenv("MASTER_PORT", str(torch_port_ranks.free_port()))
        with mesh_lib.process_group("cpu"):
            assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert not dist.is_initialized()
        monkeypatch.setenv("MASTER_PORT", str(torch_port_ranks.free_port()))
        with pytest.raises(RuntimeError, match="the run failed"):
            with mesh_lib.process_group("cpu"):
                raise RuntimeError("the run failed")
        assert dist.is_initialized()
        with mesh_lib.process_group("cpu"):
            mesh_lib.barrier()
        assert dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
