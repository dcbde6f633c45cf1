"""The metric networks and their weight tooling, the port against the JAX
package on the CPU:

- I3D on 1 x 9 x 32 x 32 (the stride-2 stem and pools pad asymmetrically
  there) on the tfhub-layout state synthesized over the pinned layout,
  converted by each package's converter: logits within 1e-5 of their
  largest magnitude; the embedder resizing 1 x 9 x 48 x 40 clips to 32
  (antialiased bilinear, as jax.image.resize) within 1e-4 of it;
- LPIPS on 2 x 32 x 32 on the synthesized lpips/VGG16 states: distances
  within 1e-5 relative;
- each converter (InceptionV3, I3D, LPIPS) against JAX's on the same
  synthesized state: the port's state dict equals JAX's variables carried
  over by compat/from_flax.py, bit for bit; missing and unknown keys raise;
- the port's copies of layouts/*.json and golden_activations.json are
  byte-equal to the JAX package's;
- the port's signatures of the synthesized states pass the shipped goldens
  at the unchanged rtol 2e-3 / atol 1e-4, and a perturbed kernel fails them.
"""

import filecmp
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.compat import metric_weights as jmw
from playableenvironments_tpu.compat import weight_validation as jwv
from playableenvironments_tpu.eval import i3d as ji3d
from playableenvironments_tpu.eval.perceptual import LPIPS as JaxLPIPS
from playableenvironments_tpu_torch.compat import from_flax
from playableenvironments_tpu_torch.compat import metric_weights as mw
from playableenvironments_tpu_torch.compat import weight_validation as wv
from playableenvironments_tpu_torch.eval.i3d import I3D, i3d_video_embedder
from playableenvironments_tpu_torch.eval.inception_v3 import InceptionV3Features
from playableenvironments_tpu_torch.eval.perceptual import LPIPS
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

NO_OPT = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@functools.partial(jax.jit, static_argnums=2, compiler_options=NO_OPT)
def jax_i3d_embedding(variables, videos, size):
    """JAX's I3D embedder (eval/i3d.py::i3d_video_embedder's forward),
    compiled without XLA's CPU optimization."""
    b, t, h, w, c = videos.shape
    if (h, w) != (size, size):
        videos = jax.image.resize(videos, (b, t, size, size, c), method="bilinear")
    return ji3d.I3D().apply(variables, videos, train=False)


def close_to_largest(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err, bound = np.abs(got - ref).max(), rel * np.abs(ref).max()
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


@pytest.fixture(scope="module")
def i3d_states():
    state = wv.synthesize_state("i3d_tfhub_keys.json", seed=1)
    net = mw.load_converted(I3D(), mw.convert_tfhub_i3d_variables(state)).eval()
    return jmw.convert_tfhub_i3d_variables(state), net


def test_i3d_matches_jax(i3d_states):
    variables, net = i3d_states
    videos = np.random.default_rng(0).random((1, 9, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax_i3d_embedding(variables, jnp.asarray(videos), 32))
    with torch.no_grad():
        got = net(torch.from_numpy(videos)).numpy()
    assert got.shape == (1, 400)
    close_to_largest(got, ref, 1e-5, "logits")


def test_i3d_embedder_resizes_as_jax(i3d_states):
    variables, net = i3d_states
    videos = np.random.default_rng(1).random((1, 9, 48, 40, 3)).astype(np.float32)
    ref = np.asarray(jax_i3d_embedding(variables, jnp.asarray(videos), 32))
    close_to_largest(i3d_video_embedder(net, resize_to=32)(videos), ref, 1e-4, "embedding")


def test_lpips_matches_jax():
    lins = wv.synthesize_state("lpips_vgg_keys.json", seed=2)
    vgg16 = wv.synthesize_state("vgg16_torch_keys.json", seed=3)
    net = mw.load_converted(LPIPS(), mw.convert_lpips_state_dict(lins, vgg16))
    rng = np.random.default_rng(2)
    a, b = (rng.random((2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    apply = jax.jit(JaxLPIPS().apply, compiler_options=NO_OPT)
    ref = np.asarray(apply(jmw.convert_lpips_state_dict(lins, vgg16), jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = net(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("name,convert,jax_convert,make,load", [
    ("inception_v3_torch_keys.json", mw.convert_torch_inception_state_dict, jmw.convert_torch_inception_state_dict,
     InceptionV3Features, from_flax.load_inception),
    ("i3d_tfhub_keys.json", mw.convert_tfhub_i3d_variables, jmw.convert_tfhub_i3d_variables, I3D, from_flax.load_i3d),
    ("lpips", None, None, LPIPS, lambda net, variables: from_flax.load_flax_tree(net, variables["params"])),
])
def test_converters_match_jax(name, convert, jax_convert, make, load):
    """The port's converted state dict against JAX's converted variables
    carried into the same module by compat/from_flax.py, bit for bit."""
    if name == "lpips":
        states = (wv.synthesize_state("lpips_vgg_keys.json", seed=2), wv.synthesize_state("vgg16_torch_keys.json"))
        got, ref = mw.convert_lpips_state_dict(*states), jmw.convert_lpips_state_dict(*states)
    else:
        state = wv.synthesize_state(name)
        got, ref = convert(state), jax_convert(state)
    carried = make()
    load(carried, ref)
    assert set(got) == set(carried.state_dict())
    for key, value in carried.state_dict().items():
        assert torch.equal(got[key], value), key
    mw.load_converted(make(), got)


def test_converters_refuse_wrong_layouts():
    state = wv.synthesize_state("inception_v3_torch_keys.json")
    state["fc.weight"] = np.zeros((1008, 2048), np.float32)  # the classifier is dropped
    state["Conv2d_1a_3x3.bn.num_batches_tracked"] = np.zeros((), np.int64)
    mw.convert_torch_inception_state_dict(state)
    with pytest.raises(KeyError, match="unrecognized"):
        mw.convert_torch_inception_state_dict({**state, "Mixed_8a.branch1x1.conv.weight": np.zeros((4, 4, 1, 1))})
    del state["Mixed_6b.branch7x7_1.conv.weight"]
    with pytest.raises(KeyError, match="torchvision/pytorch_fid layout"):
        mw.convert_torch_inception_state_dict(state)
    i3d = wv.synthesize_state("i3d_tfhub_keys.json")
    del i3d["RGB/inception_i3d/Mixed_4d/Branch_2/Conv3d_0b_3x3/conv_3d/w"]
    with pytest.raises(KeyError, match="tfhub"):
        mw.convert_tfhub_i3d_variables(i3d)
    lins = wv.synthesize_state("lpips_vgg_keys.json")
    del lins["lin3.model.1.weight"]
    with pytest.raises(KeyError, match="lpips package layout"):
        mw.convert_lpips_state_dict(lins, wv.synthesize_state("vgg16_torch_keys.json"))
    with pytest.raises(KeyError, match="differ"):
        mw.load_converted(LPIPS(), {})


def test_data_files_are_the_jax_packages():
    jax_dir = os.path.dirname(jwv.GOLDEN_PATH)
    names = sorted(os.listdir(jwv.LAYOUTS_DIR))
    assert names and names == sorted(os.listdir(wv.LAYOUTS_DIR))
    for name in names:
        assert filecmp.cmp(os.path.join(jwv.LAYOUTS_DIR, name), os.path.join(wv.LAYOUTS_DIR, name), shallow=False)
    assert filecmp.cmp(jwv.GOLDEN_PATH, wv.GOLDEN_PATH, shallow=False)
    assert os.path.dirname(wv.GOLDEN_PATH) != jax_dir
    for layout in names:
        ref, got = jwv.synthesize_state(layout, 3), wv.synthesize_state(layout, 3)
        assert set(got) == set(ref) and all(np.array_equal(got[k], ref[k]) for k in ref)


def test_signatures_pass_the_shipped_goldens():
    signatures = wv.compute_signatures(wv.synthetic_variables())
    report = wv.compare_signatures(signatures, wv.load_goldens())
    assert {name: verdict["status"] for name, verdict in report.items()} == dict.fromkeys(
        ("inception_v3", "i3d", "lpips", "vgg19"), "PASS")
    variables = wv.synthetic_variables()
    variables["lpips"]["backbone.conv0_0.weight"] = variables["lpips"]["backbone.conv0_0.weight"] + 0.01
    report = wv.compare_signatures(wv.compute_signatures({"lpips": variables["lpips"]}), wv.load_goldens())
    assert report["lpips"]["status"] == "FAIL"
    assert {report[name]["status"] for name in ("inception_v3", "i3d", "vgg19")} == {"MISSING"}
