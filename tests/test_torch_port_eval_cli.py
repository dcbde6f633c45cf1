"""The evaluation CLIs end to end on the CPU (`--device cpu`), called
in-process, on configs/synthetic_smoke.yaml over data.synthetic's test
split (2 videos of 4 frames at 16x24) from seeded phase-2 and phase-3
checkpoints of the port (train/checkpointing.py):

- the three generate_* CLIs write mirrors of the split (every frame, the
  annotations; the playability mirror's metadata.pkl with the inferred
  actions of each window but its last frame) and their timing files with
  B1-B5 launch deltas;
- the four evaluate_* CLIs and `fid` on those trees: their YAML keys equal
  the JAX package's evaluators' on the same two trees
  (`vgg_cosine_similarity_selfconsistent`, `fvd_error` included), and
  their values, with JAX's VGG19 variables (PRNGKey(0)) carried into the
  port's metric networks, within 1e-4 relative for MSE, PSNR, SSIM,
  motion-masked MSE and the VGG similarity (f32 sums over other orders),
  1e-3 relative (and 1e-9 absolute) for FID and FVD (an f64 sqrtm of f32
  embeddings), and equal for the action-space diagnostics (f64 from the
  same annotations and actions); the plots under the JAX module's names;
- `--detector_checkpoint` raises NotImplementedError naming ROADMAP's
  detector item, and every CLI raises without a card unless `--device cpu`.
"""

import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from playableenvironments_tpu.eval import distribution_metrics as jdm
from playableenvironments_tpu.eval import evaluators as jevaluators
from playableenvironments_tpu_torch.cli import common
from playableenvironments_tpu_torch.data.synthetic import make_synthetic_dataset
from playableenvironments_tpu_torch.eval import distribution_metrics, evaluators
from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
from playableenvironments_tpu_torch.train import checkpointing
from playableenvironments_tpu_torch.train.trainer_playable import PlayableTrainer, PlayableTrainingConfig
from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer
from test_torch_port_eval_metrics import port_vgg, serve_jax_vgg_init
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = "playableenvironments_tpu_torch.cli."
OBSERVATIONS = 2  # the creators' windows: frames 0-1 and 2-3 of each video
CLIP = 2  # FVD clips


def run_cli(module, *args):
    argv = sys.argv
    sys.argv = [CLI + module] + [str(a) for a in args]
    try:
        return importlib.import_module(CLI + module).main()
    finally:
        sys.argv = argv


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The config and the seeded phase-2 and phase-3 checkpoints."""
    root = str(tmp_path_factory.mktemp("port_eval_cli"))
    make_synthetic_dataset(os.path.join(root, "data"), videos=2, frames=4, height=16, width=24, splits=("test",))
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
    return {"root": root, "config": config, "cfg": cfg, "environment": environment, "playable": playable,
            "results": os.path.join(root, "results", cfg["logging"]["run_name"])}


@pytest.fixture(scope="module")
def trees(workdir):
    """The three generate CLIs' mirrors."""
    c = workdir["config"]
    return {
        "reconstructed": run_cli("generate_reconstructed_dataset", "--config", c, "--checkpoint",
                                 workdir["environment"], "--device", "cpu"),
        "camera": run_cli("generate_reconstructed_camera_manipulation_dataset", "--config", c, "--checkpoint",
                          workdir["environment"], "--observations_count", OBSERVATIONS, "--device", "cpu"),
        "playability": run_cli("generate_reconstructed_playability_dataset", "--config", c,
                               "--environment_checkpoint", workdir["environment"], "--playable_checkpoint",
                               workdir["playable"], "--observations_count", OBSERVATIONS, "--device", "cpu"),
    }


def test_generate_clis_write_mirrors(workdir, trees):
    reference = os.path.join(workdir["cfg"]["data"]["data_root"], "test")
    for name, tree in trees.items():
        for video in ("00000", "00001"):
            files = sorted(os.listdir(os.path.join(tree, video, "00000")))
            assert files == sorted(os.listdir(os.path.join(reference, video, "00000"))), name
    for cli in ("generate_reconstructed_dataset", "generate_reconstructed_camera_manipulation_dataset",
                "generate_reconstructed_playability_dataset"):
        with open(os.path.join(workdir["results"], f"timing_{cli}.json")) as f:
            timing = json.load(f)
        assert timing["seconds"]["steps"] > 0 and set(timing["launches"]) >= {"fused_adain_nerf", "fused_rollout_fwd"}
    import pickle

    with open(os.path.join(trees["playability"], "00000", "00000", "metadata.pkl"), "rb") as f:
        metadata = pickle.load(f)
    assert [("inferred_action" in entry) for entry in metadata] == [True, False, True, False]
    assert all(0 <= entry["inferred_action"] < 4 for entry in metadata[::2])


@pytest.fixture(scope="module")
def jax_defaults():
    """JAX's default metric networks (VGG19 from PRNGKey(0), the only key its
    evaluators pass), built and compiled once for the module: each JAX
    evaluator would otherwise build and compile them again."""
    built = {}

    def once(name, make):
        def cached(*args, **kwargs):
            if name not in built:
                built[name] = make(*args, **kwargs)
            return built[name]
        return cached

    patch = pytest.MonkeyPatch()
    serve_jax_vgg_init(patch)
    # Initialized on a small input: the weights do not depend on its size.
    patch.setattr(jdm, "default_image_embedder", once(
        "image", lambda key, image_size=None, make=jdm.default_image_embedder: make(key, (16, 16))))
    patch.setattr(jdm, "default_video_embedder", once(
        "video", lambda key, image_size=None, make=jdm.default_video_embedder: make(key, (16, 16))))
    patch.setattr(jevaluators, "_make_vgg_sim_fn", once("similarity", jevaluators._make_vgg_sim_fn))
    yield
    patch.undo()


@pytest.fixture
def jax_weights(monkeypatch, jax_defaults):
    """The port's metric networks on JAX's VGG19 variables (PRNGKey(0)),
    the weights of the JAX evaluators' defaults."""
    def init(cuts=5, device="cpu", seed=0):
        assert seed == 0 and str(device) == "cpu"
        return port_vgg(cuts)

    monkeypatch.setattr(evaluators, "init_vgg19", init)
    monkeypatch.setattr(distribution_metrics, "init_vgg19", init)


def close_results(got, ref):
    """The tolerances of the module docstring, key by key."""
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for key, value in ref.items():
        if isinstance(value, str):
            assert got[key] == value, key
        elif key in ("fid", "fvd"):
            np.testing.assert_allclose(got[key], value, rtol=1e-3, atol=1e-9, err_msg=key)
        elif key in ("mse", "psnr", "ssim", "motion_masked_mse", "vgg_cosine_similarity_selfconsistent"):
            np.testing.assert_allclose(got[key], value, rtol=1e-4, err_msg=key)
        else:
            assert got[key] == value or (np.isnan(got[key]) and np.isnan(value)), key


@pytest.mark.parametrize("cli,tree,args,make_ref", [
    ("evaluate_reconstructed_dataset", "reconstructed", ["--window_size", OBSERVATIONS],
     lambda plots: jevaluators.ReconstructedDatasetEvaluator(window_size=OBSERVATIONS)),
    ("evaluate_reconstructed_camera_manipulation_dataset", "camera", [],
     lambda plots: jevaluators.ReconstructedDatasetEvaluator()),
    ("evaluate_reconstructed_playability_dataset", "playability", [],
     lambda plots: jevaluators.ReconstructedPlayabilityDatasetEvaluator(actions_count=4, plots_directory=plots)),
    ("evaluate_fvd_reconstructed_dataset", "reconstructed", ["--clip_length", CLIP],
     lambda plots: jevaluators.ReconstructedDatasetFVDEvaluator(clip_length=CLIP)),
])
def test_evaluate_clis_match_jax_evaluators(workdir, trees, jax_weights, tmp_path, cli, tree, args, make_ref):
    output = str(tmp_path / "results.yaml")
    got = run_cli(cli, "--config", workdir["config"], "--generated", trees[tree], "--output", output, *args,
                  "--device", "cpu")
    with open(output) as f:
        written = yaml.safe_load(f)
    assert set(written) == set(got)
    for key, value in got.items():
        assert written[key] == value or (np.isnan(written[key]) and np.isnan(value)), key
    reference = os.path.join(workdir["cfg"]["data"]["data_root"], "test")
    ref = make_ref(str(tmp_path / "jax_plots")).compute_metrics(reference, trees[tree])
    close_results(got, ref)
    with open(os.path.join(workdir["results"], f"timing_{cli}.json")) as f:
        seconds = json.load(f)["seconds"]
    assert seconds.get("decode", 0) > 0 and seconds.get("networks", 0) > 0
    if tree == "playability":
        assert "delta_mse_action_accuracy" in got and "fvd_error" in got  # 4-frame videos hold no 8-frame clip
        assert sorted(os.listdir(os.path.join(workdir["results"], "plots"))) == sorted(
            os.listdir(tmp_path / "jax_plots"))


def test_fid_cli_matches_jax(workdir, trees, jax_weights):
    reference = os.path.join(workdir["cfg"]["data"]["data_root"], "test")
    got = run_cli("fid", reference, trees["reconstructed"], "--batch_size", 3, "--device", "cpu")
    from playableenvironments_tpu.cli.fid import _image_paths
    from playableenvironments_tpu.data.video import _load_image

    fid = jdm.IncrementalFID()
    for update, directory in ((fid.update_reference, reference), (fid.update_generated, trees["reconstructed"])):
        update(np.stack([_load_image(p) for p in _image_paths(directory)]))
    np.testing.assert_allclose(got, fid.compute(), rtol=1e-3, atol=1e-9)


def test_detector_checkpoint_raises(workdir, trees):
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, Evaluation: the detector"):
        run_cli("evaluate_reconstructed_dataset", "--config", workdir["config"], "--generated",
                trees["reconstructed"], "--detector_checkpoint", "x", "--device", "cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where no card is present")
@pytest.mark.parametrize("module,args", [
    ("generate_reconstructed_dataset", ["--checkpoint", "x"]),
    ("generate_reconstructed_camera_manipulation_dataset", ["--checkpoint", "x"]),
    ("generate_reconstructed_playability_dataset", ["--environment_checkpoint", "x", "--playable_checkpoint", "x"]),
    ("evaluate_reconstructed_dataset", ["--generated", "x"]),
    ("evaluate_reconstructed_camera_manipulation_dataset", ["--generated", "x"]),
    ("evaluate_reconstructed_playability_dataset", ["--generated", "x"]),
    ("evaluate_fvd_reconstructed_dataset", ["--generated", "x"]),
])
def test_each_eval_cli_raises_without_a_card(workdir, module, args):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli(module, "--config", workdir["config"], *args)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where no card is present")
def test_fid_cli_raises_without_a_card(workdir):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli("fid", workdir["root"], workdir["root"])
