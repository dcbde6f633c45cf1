"""The detector and metric-weight CLIs end to end on the CPU (`--device
cpu`), called in-process, on a tiny synthetic dataset (data.synthetic:
train, val and test splits of 2 videos x 4 frames at 32x48):

- train_detector runs 50 steps at base_features 8, logs the losses' means
  at step 50 and its val evaluation every 25 steps, writes its timing file
  and a checkpoint that restores the trainer's state bit for bit;
- evaluate_reconstructed_dataset --detector_checkpoint, on weights made in
  JAX and brought in through scripts/export_flax_checkpoint.py's `.npz`
  (compat/from_flax.py::load_npz, load_detector): its MDR and ADD equal the
  JAX evaluator's with that detector on the same two trees (ADD within 1e-6
  relative; detections within 1e-6 of JAX's are matched alike);
- the evaluator built in code with that detector, LPIPS and a pretrained
  VGG19 (synthesized published-layout states, converted by each package):
  every key equals JAX's evaluator's, the values within 1e-4 relative for
  MSE, PSNR, SSIM, masked MSE, LPIPS and the VGG similarity (f32 sums in
  other orders) and 1e-6 for MDR/ADD;
- validate_metric_weights exits 0 on the self-check, non-zero on a
  corrupted synthesized state, round-trips --write_goldens / --goldens on
  synthesized published-layout files, and reports MISSING for a subset
  run;
- both CLIs raise without a card unless `--device cpu`.
"""

import importlib
import json
import os
import pathlib
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from playableenvironments_tpu.compat import metric_weights as jmw
from playableenvironments_tpu.eval import evaluators as jevaluators
from playableenvironments_tpu.eval.perceptual import LPIPS as JaxLPIPS
from playableenvironments_tpu.eval.perceptual import VGG19_PLAN as JAX_VGG19_PLAN
from playableenvironments_tpu.eval.perceptual import convert_torch_vgg_state_dict as jax_convert_vgg
from playableenvironments_tpu.train import checkpointing as jcheckpointing
from playableenvironments_tpu.train import trainer_detector as jtd
from playableenvironments_tpu.train.state import TrainState
from playableenvironments_tpu_torch.compat import from_flax
from playableenvironments_tpu_torch.compat import metric_weights as mw
from playableenvironments_tpu_torch.compat import weight_validation as wv
from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.data.synthetic import make_synthetic_dataset
from playableenvironments_tpu_torch.eval import evaluators
from playableenvironments_tpu_torch.eval.perceptual import (LPIPS, VGG19_CUTS, VGG19_PLAN, VGGFeatures,
                                                            load_torch_vgg_state_dict, lpips_distance_fn)
from playableenvironments_tpu_torch.train import checkpointing
from playableenvironments_tpu_torch.train.trainer_detector import (DetectorTrainer, DetectorTrainingConfig,
                                                                   dataset_detection_batches)
from test_torch_port_detector import NO_OPT, jax_variables
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = "playableenvironments_tpu_torch.cli."
FEATURES = 8
WINDOW = 2


def run_cli(module, *args):
    argv = sys.argv
    sys.argv = [CLI + module] + [str(a) for a in args]
    try:
        return importlib.import_module(CLI + module).main()
    finally:
        sys.argv = argv


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The dataset, its test split with noise added to every frame standing
    for a generated tree, and the config with a `detector_training`
    section."""
    root = str(tmp_path_factory.mktemp("port_detector_cli"))
    data = make_synthetic_dataset(os.path.join(root, "data"), videos=2, frames=4, height=32, width=48,
                                  splits=("train", "val", "test"))
    generated = shutil.copytree(os.path.join(data, "test"), os.path.join(root, "generated"))
    rng = np.random.default_rng(3)
    for png in sorted(pathlib.Path(generated).rglob("*.png")):
        pixels = np.asarray(Image.open(png), np.int16)
        Image.fromarray(np.clip(pixels + rng.integers(-12, 13, pixels.shape), 0, 255).astype(np.uint8)).save(png)
    with open(os.path.join(REPO, "configs", "synthetic_smoke.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["data_root"] = data
    cfg["logging"].update(output_root=os.path.join(root, "results"), checkpoints_root=os.path.join(root, "ckpt"))
    cfg["detector_training"] = {"base_features": FEATURES, "learning_rate": 3e-3, "eval_freq": 25, "eval_batches": 1}
    config = os.path.join(root, "smoke.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    return {"root": root, "config": config, "data": data, "generated": generated,
            "results": os.path.join(root, "results", cfg["logging"]["run_name"])}


def test_train_detector_cli(workdir):
    out = run_cli("train_detector", "--config", workdir["config"], "--max_steps", 50, "--batch_size", 2,
                  "--device", "cpu")
    assert len(out["losses"]) == 50 and np.isfinite(out["losses"]).all()
    assert out["checkpoint"].endswith("detector/checkpoint_50")
    with open(os.path.join(workdir["results"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r for r in records if "loss" in r]
    assert [r["step"] for r in losses] == [50]
    assert {"heatmap_loss", "size_loss", "offset_loss"} <= set(losses[0])
    np.testing.assert_allclose(losses[0]["loss"], np.mean(out["losses"]), rtol=1e-6)
    assert [r["step"] for r in records if "val_missed_detection_rate" in r] == [25, 50]
    assert set(out["validation"]) == {"missed_detection_rate", "average_detection_distance",
                                      "mean_detections_per_image"}
    with open(os.path.join(workdir["results"], "timing_train_detector.json")) as f:
        timing = json.load(f)
    assert len(timing["step_seconds"]) == 50 and timing["seconds"]["evaluation"] > 0
    trainer = DetectorTrainer(DetectorTrainingConfig(base_features=FEATURES), device="cpu", seed=5)
    checkpointing.restore_checkpoint(out["checkpoint"], trainer)
    assert trainer.step == 50
    assert checkpointing.state_difference(checkpointing.flat_state(trainer),
                                          checkpointing.saved_flat_state(out["checkpoint"])) is None


@pytest.fixture(scope="module")
def jax_detector(workdir):
    """A JAX detector trained 60 steps on the train split, its heatmap bias
    then raised by 1 so that the player's peak crosses detect_fn's 0.3 in
    eval mode, saved by the JAX package and exported to the `.npz` bridge;
    the port's checkpoint of the same weights."""
    variables = jax_variables()
    trainer = jtd.DetectorTrainer(jtd.DetectorTrainingConfig(learning_rate=3e-3, base_features=FEATURES))
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=trainer.tx.init(variables["params"]), step=jnp.zeros((), jnp.int32), tx=trainer.tx)
    dataset = MulticameraVideoDataset(os.path.join(workdir["data"], "train"), observations_count=1)
    batch = [np.asarray(x) for x in next(dataset_detection_batches(dataset, 8, shuffle=False))]
    step = jax.jit(trainer.train_step, compiler_options=NO_OPT)
    for _ in range(60):
        state, _ = step(state, *batch)
    params = jax.device_get(state.params)
    params["heatmap_head"]["bias"] = params["heatmap_head"]["bias"] + 1.0
    state = state.replace(params=params)
    directory = os.path.join(workdir["root"], "jax_detector")
    jcheckpointing.save_checkpoint(directory, state)
    spec = importlib.util.spec_from_file_location("export_flax_checkpoint",
                                                  os.path.join(REPO, "scripts", "export_flax_checkpoint.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    npz = os.path.join(workdir["root"], "detector.npz")
    export.export(os.path.join(directory, "checkpoint_60"), npz)
    imported, step = from_flax.load_npz(npz)
    assert step == 60
    port = DetectorTrainer(DetectorTrainingConfig(base_features=FEATURES), device="cpu")
    from_flax.load_detector(port.model, imported)
    checkpoint = checkpointing.save_checkpoint(os.path.join(workdir["root"], "port_detector"), port)
    return trainer, state, checkpoint, port


def metric_networks():
    """LPIPS and a VGG19 to relu3_1 on synthesized published-layout states,
    converted by each package: (JAX's lpips_fn, JAX's VGG variables, the
    port's lpips_fn, the port's VGG)."""
    lins = wv.synthesize_state("lpips_vgg_keys.json", seed=2)
    vgg16 = wv.synthesize_state("vgg16_torch_keys.json", seed=3)
    vgg19 = wv.synthesize_state("vgg19_torch_keys.json", seed=4)
    lpips_variables = jmw.convert_lpips_state_dict(lins, vgg16)
    jax_lpips = jax.jit(lambda a, b: JaxLPIPS().apply(lpips_variables, a, b))
    lpips = mw.load_converted(LPIPS(), mw.convert_lpips_state_dict(lins, vgg16))
    vgg = load_torch_vgg_state_dict(VGGFeatures(VGG19_PLAN, VGG19_CUTS[:3]),
                                    {k: torch.from_numpy(v) for k, v in vgg19.items()})
    return jax_lpips, jax_convert_vgg(vgg19, JAX_VGG19_PLAN), lpips_distance_fn(lpips), vgg


def test_evaluate_with_detector_matches_jax(workdir, jax_detector):
    trainer, state, checkpoint, port = jax_detector
    reference = os.path.join(workdir["data"], "test")
    jax_lpips, jax_vgg, lpips_fn, vgg = metric_networks()
    ref = jevaluators.ReconstructedDatasetEvaluator(window_size=WINDOW, detector=trainer.detect_fn(state),
                                                    lpips_fn=jax_lpips, compute_fid=False,
                                                    vgg_variables=jax_vgg).compute_metrics(reference,
                                                                                           workdir["generated"])
    assert ref["missed_detection_rate"] < 1, "the detector should find players"

    got = run_cli("evaluate_reconstructed_dataset", "--config", workdir["config"], "--generated",
                  workdir["generated"], "--window_size", WINDOW, "--no_fid", "--detector_checkpoint", checkpoint,
                  "--output", os.path.join(workdir["root"], "detection.yaml"), "--device", "cpu")
    for key in ("missed_detection_rate", "average_detection_distance"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, err_msg=key)

    built = evaluators.ReconstructedDatasetEvaluator(window_size=WINDOW, detector=port.detect_fn(), lpips_fn=lpips_fn,
                                                     compute_fid=False, vgg=vgg, device="cpu")
    got = built.compute_metrics(reference, workdir["generated"])
    assert set(got) == set(ref) and "lpips" in got and "vgg_cosine_similarity" in got
    for key, value in ref.items():
        rtol = 1e-6 if key in ("missed_detection_rate", "average_detection_distance") else 1e-4
        np.testing.assert_allclose(got[key], value, rtol=rtol, err_msg=key)


def test_validate_metric_weights_cli(workdir, monkeypatch):
    report = run_cli("validate_metric_weights", "--device", "cpu")
    assert {name: verdict["status"] for name, verdict in report.items()} == dict.fromkeys(
        ("inception_v3", "i3d", "lpips", "vgg19"), "PASS")

    synthesize = wv.synthesize_state

    def corrupted(layout, seed=0):
        state = synthesize(layout, seed)
        if layout == "lpips_vgg_keys.json":
            state["lin0.model.1.weight"] = state["lin0.model.1.weight"] * 3.0
        return state

    monkeypatch.setattr(wv, "synthesize_state", corrupted)
    with pytest.raises(SystemExit, match="FAILED: \\['lpips'\\]"):
        run_cli("validate_metric_weights", "--device", "cpu")
    monkeypatch.undo()

    # Published-layout files: record their signatures, then compare.
    files = {}
    for flag, layout, seed in (("--lpips_lins", "lpips_vgg_keys.json", 2), ("--vgg16", "vgg16_torch_keys.json", 3),
                               ("--vgg19", "vgg19_torch_keys.json", 4)):
        files[flag] = os.path.join(workdir["root"], f"{layout}.pth")
        torch.save({k: torch.from_numpy(v) for k, v in wv.synthesize_state(layout, seed).items()}, files[flag])
    args = [a for flag, path in files.items() for a in (flag, path)]
    goldens = os.path.join(workdir["root"], "goldens.json")
    written = run_cli("validate_metric_weights", *args, "--write_goldens", goldens, "--device", "cpu")
    with open(goldens) as f:
        assert json.load(f) == written and set(written) == {"lpips", "vgg19"}
    report = run_cli("validate_metric_weights", *args, "--goldens", goldens, "--device", "cpu")
    assert {name: verdict["status"] for name, verdict in report.items()} == {"lpips": "PASS", "vgg19": "PASS"}

    # A subset against the shipped goldens: the others are MISSING.
    shipped = os.path.join(workdir["root"], "shipped.json")
    shutil.copy(wv.GOLDEN_PATH, shipped)
    report = run_cli("validate_metric_weights", "--vgg19", files["--vgg19"], "--goldens", shipped, "--device", "cpu")
    assert {name: verdict["status"] for name, verdict in report.items()} == {
        "vgg19": "PASS", "inception_v3": "MISSING", "i3d": "MISSING", "lpips": "MISSING"}


@pytest.mark.parametrize("module,args", [("train_detector", ["--config", "x"]), ("validate_metric_weights", [])])
def test_cli_raises_without_a_card(module, args):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli(module, *args)
