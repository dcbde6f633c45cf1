"""Parity of the metric networks' weights, by golden activation signatures.

Port of playableenvironments_tpu/compat/weight_validation.py. The published
InceptionV3, I3D, LPIPS and VGG weights do not ship with the repo, so the
metric stack is held by two checks:

1. The synthetic self-check (no weight files): state dicts are synthesized
   deterministically over the pinned published key layouts (`layouts/*.json`,
   the port's copies of the JAX package's), converted by the real
   converters (compat/metric_weights.py, eval/perceptual.py's VGG19 one),
   run on fixed inputs and compared with the golden signatures of
   `golden_activations.json` (the JAX package's file, copied): a converter,
   topology or layout that changed breaks it.
2. The real-weight check: the same signatures of a user's files,
   recorded once with `write_goldens` and compared on later runs or other
   machines against that record.

The JAX package pins its signatures to the CPU; the port computes them on
the device it is given, in IEEE f32 (InceptionV3's and I3D's forwards turn
cuDNN's TF32 off; the VGG and LPIPS signatures run inside the same
context here), so that a card reads the goldens as the CPU does. The deep
embedders take inputs at their native sizes (299, 224), so that no resize
sits in the signature path.

CLI: `python -m playableenvironments_tpu_torch.cli.validate_metric_weights`.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from playableenvironments_tpu_torch.compat import metric_weights as mw
from playableenvironments_tpu_torch.eval.inception_v3 import ieee_convolutions

LAYOUTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "layouts")
GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_activations.json")

_INPUT_SEED = 1234


def synthesize_state(layout_name: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """A deterministic state dict over a pinned key layout (`layouts/`).

    Scales matter, not only shapes: He-scaled weight tensors, batch norm
    gammas and variances near 1 and small biases keep activations of order
    1 through ~90 layers, so that every layer's values weigh in the
    signature (with tiny uniform weights the embedding would degenerate to
    the last biases, and a corrupted early layer would go unseen)."""
    with open(os.path.join(LAYOUTS_DIR, layout_name)) as f:
        keys = json.load(f)
    # tfhub kernels are (t, h, w, in, out); torch kernels are (out, in, h, w).
    fan_out_axis = -1 if "tfhub" in layout_name else 0
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in keys.items():
        leaf = key.rsplit(".", 1)[-1]
        if "var" in leaf or key.endswith("moving_variance"):
            value = 1.0 + np.abs(rng.normal(scale=0.1, size=shape))
        elif len(shape) >= 2:
            fan_in = max(int(np.prod(shape)) // int(shape[fan_out_axis]), 1)
            value = rng.normal(scale=np.sqrt(2.0 / fan_in), size=shape)
        elif leaf in ("weight", "gamma"):
            value = 1.0 + rng.normal(scale=0.05, size=shape)  # batch norm gamma
        else:
            value = rng.normal(scale=0.05, size=shape)  # bias, beta, mean
        out[key] = value.astype(np.float32)
    return out


def _signature(values) -> Dict:
    flat = np.asarray(values, np.float64).reshape(-1)
    return {"mean": float(flat.mean()), "std": float(flat.std()), "head": [float(v) for v in flat[:8]]}


def _inception_signature(state: Dict[str, torch.Tensor], device) -> Dict:
    from playableenvironments_tpu_torch.eval.inception_v3 import InceptionV3Features, inception_image_embedder

    net = mw.load_converted(InceptionV3Features(), state).to(device).eval()
    images = np.random.default_rng(_INPUT_SEED).random((2, 299, 299, 3)).astype(np.float32)
    return _signature(inception_image_embedder(net)(images))


def _i3d_signature(state: Dict[str, torch.Tensor], device) -> Dict:
    from playableenvironments_tpu_torch.eval.i3d import I3D, i3d_video_embedder

    net = mw.load_converted(I3D(), state).to(device).eval()
    videos = np.random.default_rng(_INPUT_SEED + 1).random((1, 16, 224, 224, 3)).astype(np.float32)
    return _signature(i3d_video_embedder(net)(videos))


@torch.no_grad()
def _lpips_signature(state: Dict[str, torch.Tensor], device) -> Dict:
    from playableenvironments_tpu_torch.eval.perceptual import LPIPS

    net = mw.load_converted(LPIPS(), state).to(device)
    rng = np.random.default_rng(_INPUT_SEED + 2)
    a = torch.from_numpy(rng.random((2, 64, 64, 3)).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.random((2, 64, 64, 3)).astype(np.float32)).to(device)
    with ieee_convolutions(device):
        return _signature(net(a, b).cpu().numpy())


@torch.no_grad()
def _vgg19_signature(state: Dict[str, torch.Tensor], device) -> Dict:
    from playableenvironments_tpu_torch.eval.perceptual import VGG19_CUTS, VGG19_PLAN, VGGFeatures

    net = VGGFeatures(VGG19_PLAN, VGG19_CUTS)
    net = mw.load_converted(net, {name: state[name] for name in net.state_dict()}).to(device)
    images = torch.from_numpy(np.random.default_rng(_INPUT_SEED + 3).random((2, 64, 64, 3)).astype(np.float32))
    with ieee_convolutions(device):
        features = net(images.to(device))
    return _signature(np.concatenate([f.double().mean(dim=(2, 3)).reshape(-1).cpu().numpy() for f in features]))


SIGNATURE_FNS: Dict[str, Callable[[Dict[str, torch.Tensor], torch.device], Dict]] = {
    "inception_v3": _inception_signature,
    "i3d": _i3d_signature,
    "lpips": _lpips_signature,
    "vgg19": _vgg19_signature,
}


def synthetic_variables() -> Dict[str, Dict[str, torch.Tensor]]:
    """Synthesized published-layout state dicts through the real converters
    (the path real weights take): {embedder: the port module's state dict}."""
    from playableenvironments_tpu_torch.eval.perceptual import VGG19_PLAN, convert_torch_vgg_state_dict

    vgg19 = {k: torch.from_numpy(v) for k, v in synthesize_state("vgg19_torch_keys.json", seed=4).items()}
    return {
        "inception_v3": mw.convert_torch_inception_state_dict(synthesize_state("inception_v3_torch_keys.json")),
        "i3d": mw.convert_tfhub_i3d_variables(synthesize_state("i3d_tfhub_keys.json", seed=1)),
        "lpips": mw.convert_lpips_state_dict(synthesize_state("lpips_vgg_keys.json", seed=2),
                                             synthesize_state("vgg16_torch_keys.json", seed=3)),
        "vgg19": convert_torch_vgg_state_dict(vgg19, VGG19_PLAN),
    }


def compute_signatures(variables_by_name: Mapping[str, Dict[str, torch.Tensor]], device="cpu") -> Dict[str, Dict]:
    """{embedder: signature} of each converted state dict, its network run
    on `device`."""
    device = torch.device(device)
    return {name: SIGNATURE_FNS[name](state, device) for name, state in variables_by_name.items()}


def compare_signatures(computed: Mapping[str, Dict], golden: Mapping[str, Dict], rtol: float = 2e-3,
                       atol: float = 1e-4) -> Dict[str, Dict]:
    """Per-embedder verdicts: PASS when mean, std and head are all within
    the tolerances, FAIL otherwise; a golden entry with no computed
    counterpart reports MISSING (so that a subset run does not read as full
    coverage) and a computed one without a golden NO_GOLDEN."""
    report = {name: {"status": "MISSING"} for name in golden if name not in computed}
    for name, signature in computed.items():
        if name not in golden:
            report[name] = {"status": "NO_GOLDEN"}
            continue
        reference = golden[name]
        fields = {field: bool(np.allclose(np.asarray(signature[field], np.float64),
                                          np.asarray(reference[field], np.float64), rtol=rtol, atol=atol))
                  for field in ("mean", "std", "head")}
        report[name] = {"status": "PASS" if all(fields.values()) else "FAIL", "fields": fields,
                        "computed": signature, "golden": reference}
    return report


def largest_relative_gap(signature: Dict, golden: Dict) -> float:
    """The largest |computed - golden| / |golden| over mean, std and head."""
    got = np.asarray([signature["mean"], signature["std"]] + list(signature["head"]), np.float64)
    want = np.asarray([golden["mean"], golden["std"]] + list(golden["head"]), np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


def load_goldens(path: Optional[str] = None) -> Dict[str, Dict]:
    with open(path or GOLDEN_PATH) as f:
        return json.load(f)


def write_goldens(signatures: Mapping[str, Dict], path: Optional[str] = None) -> str:
    """Merge `signatures` into the JSON at `path` (default the shipped
    goldens). :return: the path written."""
    target = path or GOLDEN_PATH
    existing: Dict[str, Dict] = {}
    if os.path.isfile(target):
        with open(target) as f:
            existing = json.load(f)
    existing.update(signatures)
    with open(target, "w") as f:
        json.dump(existing, f, indent=1, sort_keys=True)
    return target
