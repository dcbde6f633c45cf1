"""The evaluation metrics, the port against the JAX package on the CPU:

- eval/metrics.py's image metrics (mse, psnr, ssim at kernel sizes 11 and
  7, motion_mask over an odd and an even count of frames, motion-masked
  MSE): 1e-5 relative (f32 sums in another order; the masks equal);
- its statistics (FeatureStatistics, frechet_distance on full-rank and on
  singular covariances, frechet_from_features, greedy_box_matching,
  DetectionScore, action_variance, action_classification_score,
  delta_mse_action_accuracy, inception_score): the same NumPy/SciPy code in
  f64, so 1e-12 relative; the logistic probe is the port's own fit of
  scikit-learn's objective with its options, its score equal;
- the default image and video embedders, IncrementalFID / IncrementalFVD and
  vgg_cosine_similarity, with JAX's VGG19 variables (PRNGKey(0), the ones
  its defaults draw) carried across by compat/from_flax.py::load_vgg:
  embeddings at 1e-4 relative to their largest, distances at 1e-3 relative
  (an f64 sqrtm of f32 embeddings), similarities at 1e-5;
- InceptionV3 at 128x128 (as tests/test_inception_v3.py) with
  load_inception, through inception_image_embedder from a larger and a
  smaller input (resize down, antialiased, and up): 1e-4 relative to the
  largest feature; the resize alone at 1e-5; the .npz loader's tree equal;
- eval/plotting.py's arrays equal to what the JAX module hands matplotlib
  (its histogram, 2-D histogram, scatter, arrow and axis-limit calls
  recorded), and every figure written under the JAX module's file names.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.eval import distribution_metrics as jdm
from playableenvironments_tpu.eval import inception_v3 as jinception
from playableenvironments_tpu.eval import metrics as jmetrics
from playableenvironments_tpu.eval import perceptual as jperceptual
from playableenvironments_tpu.eval import plotting as jplotting
from playableenvironments_tpu_torch.compat.from_flax import load_inception, load_vgg
from playableenvironments_tpu_torch.eval import distribution_metrics as dm
from playableenvironments_tpu_torch.eval import inception_v3
from playableenvironments_tpu_torch.eval import metrics
from playableenvironments_tpu_torch.eval import plotting
from playableenvironments_tpu_torch.eval.perceptual import VGG19_CUTS, VGGFeatures, vgg_cosine_similarity
from test_torch_port_decoder import NO_OPT
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

REL = 1e-5


def frames(seed, shape):
    """Smooth images in [0, 1] with a moving patch (motion-mask material)."""
    rng = np.random.default_rng(seed)
    t, h, w, c = shape
    rows, cols = np.mgrid[0:h, 0:w] / max(h, w)
    background = np.stack([0.5 + 0.3 * np.sin(5 * rows + 3 * cols + p) for p in rng.uniform(0, 6, c)], -1)
    out = np.repeat(background[None], t, axis=0)
    for k in range(t):
        out[k, 2 + k:6 + k, 3:7] = rng.uniform(0, 1, (4, 4, c))
    return out.astype(np.float32)


@pytest.mark.parametrize("kernel_size, count", [(11, 5), (7, 4)])
def test_image_metrics_match_jax(kernel_size, count):
    """Per-pair metrics over a (2, T) lead and the motion metrics of one
    sequence, at 1e-5 relative; the motion mask equal."""
    a = frames(0, (count, 24, 30, 3))
    b = np.clip(a + np.random.default_rng(1).normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    pairs = (a.reshape((2, -1) + a.shape[1:]) if count % 2 == 0 else a, b.reshape((2, -1) + a.shape[1:])
             if count % 2 == 0 else b)
    ta, tb = (torch.from_numpy(x) for x in pairs)
    ja, jb = (jnp.asarray(x) for x in pairs)
    for name, got, ref in (
            ("mse", metrics.mse(ta, tb), jmetrics.mse(ja, jb)),
            ("psnr", metrics.psnr(ta, tb), jmetrics.psnr(ja, jb)),
            ("ssim", metrics.ssim(ta, tb, kernel_size=kernel_size),
             jmetrics.ssim(ja, jb, kernel_size=kernel_size))):
        assert tuple(got.shape) == ref.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=REL, atol=0, err_msg=name)
    mask = metrics.motion_mask(torch.from_numpy(a))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmetrics.motion_mask(jnp.asarray(a))))
    assert 0 < int(mask.sum()) < mask.numel()
    np.testing.assert_allclose(float(metrics.motion_masked_mse(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jmetrics.motion_masked_mse(jnp.asarray(a), jnp.asarray(b))), rtol=REL)
    np.testing.assert_array_equal(metrics._median(torch.from_numpy(a))[0].numpy(),
                                  np.asarray(jnp.median(jnp.asarray(a), axis=0)))


def test_statistics_match_jax():
    """The f64 statistics at 1e-12 relative (exact where they count)."""
    rng = np.random.default_rng(3)
    fa, fb = rng.normal(size=(40, 6)), rng.normal(0.3, 1.2, (30, 6))
    port, ref = metrics.FeatureStatistics(6), jmetrics.FeatureStatistics(6)
    for chunk in (fa[:15], fa[15:]):
        port.update(chunk)
        ref.update(chunk)
    for got, want in zip(port.finalize(), ref.finalize()):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    close = functools.partial(np.testing.assert_allclose, rtol=1e-12, atol=1e-12)
    close(metrics.frechet_from_features(fa, fb), jmetrics.frechet_from_features(fa, fb))
    # Singular covariances: 3 samples of 6 features (rank 2), and a
    # population of one repeated vector (rank 0), against itself too.
    few, same = rng.normal(size=(3, 6)), np.repeat(rng.normal(size=(1, 6)), 4, axis=0)
    for x, y in ((few, fb), (few, few), (same, few), (same, same)):
        got, want = metrics.frechet_from_features(x, y), jmetrics.frechet_from_features(x, y)
        assert np.isfinite(got) and got >= 0.0
        close(got, want)
    assert metrics.frechet_distance(np.zeros(2), np.full((2, 2), np.nan), np.zeros(2), np.eye(2)) != 0.0
    with pytest.raises(ValueError):
        metrics.FeatureStatistics(2).finalize()

    reference, detected = rng.uniform(size=(5, 2)), rng.uniform(size=(4, 2))
    assert metrics.greedy_box_matching(reference, detected) == jmetrics.greedy_box_matching(reference, detected)
    assert metrics.greedy_box_matching(reference, detected[:0]) == []
    scores = [metrics.DetectionScore(0.3), jmetrics.DetectionScore(0.3)]
    for score in scores:
        score.update(reference, detected)
        score.update(reference[:2], detected[3:])
    assert scores[0].results() == scores[1].results()

    for k in (2, 3, 5):
        actions = rng.integers(0, k, 50)
        movements = rng.normal(0, 0.05, (50, 2)) + np.stack([np.cos(actions), np.sin(actions)], -1) * 0.03
        got, want = metrics.action_variance(movements, actions, k + 1), jmetrics.action_variance(movements, actions,
                                                                                                 k + 1)
        assert set(got) == set(want)
        for key in got:
            close(got[key], want[key], err_msg=key)
        assert metrics.delta_mse_action_accuracy(movements, actions, k) == jmetrics.delta_mse_action_accuracy(
            movements, actions, k)
        assert metrics.action_classification_score(movements, actions) == \
            jmetrics.action_classification_score(movements, actions), k
    assert np.isnan(metrics.action_classification_score(movements, np.zeros(50, int)))
    p = rng.dirichlet(np.ones(7), 20)
    for splits in (1, 3):
        close(metrics.inception_score(p, splits), jmetrics.inception_score(p, splits))


@functools.lru_cache(maxsize=None)
def jax_vgg_variables():
    """JAX's VGG19 variables to relu4_1 from PRNGKey(0), as its default
    embedders draw them (their first three cuts are init_vgg19's), from one
    compiled init: the eager init's values (test_embedders_and_similarity_
    match_jax holds init_vgg19's to them), in less than half its time."""
    net = jperceptual.VGGFeatures(jperceptual.VGG19_PLAN, jperceptual.VGG19_CUTS[:4])
    # The weights do not depend on the input's size: a small one is cheaper.
    return jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))


def serve_jax_vgg_init(monkeypatch):
    """JAX's VGGFeatures.init from PRNGKey(0) served out of
    jax_vgg_variables, the layers the module has: the weights depend on
    neither the input's size nor the cuts past those layers. Each of JAX's
    default metric networks would otherwise run an eager init of its own."""
    init = jperceptual.VGGFeatures.init

    def served(self, key, *args, **kwargs):
        if self.plan != jperceptual.VGG19_PLAN or not np.array_equal(key, jax.random.PRNGKey(0)):
            return init(self, key, *args, **kwargs)
        shapes = jax.eval_shape(functools.partial(init, self), key, *args, **kwargs)["params"]
        params = {name: jax.tree_util.tree_map(jnp.asarray, jax_vgg_variables()["params"][name]) for name in shapes}
        assert jax.tree_util.tree_map(jnp.shape, params) == jax.tree_util.tree_map(jnp.shape, dict(shapes))
        return {"params": params}

    monkeypatch.setattr(jperceptual.VGGFeatures, "init", served)


def port_vgg(cuts: int) -> VGGFeatures:
    """The port's VGGFeatures to cut `cuts` holding JAX's variables."""
    net = VGGFeatures(cuts=VGG19_CUTS[:cuts], device="cpu")
    params = {k: v for k, v in jax_vgg_variables()["params"].items() if hasattr(net, k)}
    load_vgg(net, {"params": params})
    return net.requires_grad_(False).eval()


def test_embedders_and_similarity_match_jax(monkeypatch):
    """The default embedders (1e-4 of their largest), IncrementalFID/FVD
    (1e-3 relative) and vgg_cosine_similarity (1e-5), on JAX's VGG
    variables."""
    jvars = jperceptual.init_vgg19(jax.random.PRNGKey(0), cuts=3)  # eager, as the embedders init
    for name, leaf in jax.device_get(jvars)["params"].items():  # init_vgg19's weights are the embedders'
        np.testing.assert_array_equal(leaf["kernel"], jax_vgg_variables()["params"][name]["kernel"])
    # Held equal just above, the compiled init's values serve the embedders'
    # own (eager) inits.
    serve_jax_vgg_init(monkeypatch)
    monkeypatch.setattr(dm, "init_vgg19", lambda cuts, device, seed: port_vgg(cuts))
    images = frames(5, (6, 32, 40, 3))
    generated = np.clip(images[::-1] * 0.9 + 0.05, 0, 1).astype(np.float32)
    j_image = jdm.default_image_embedder(jax.random.PRNGKey(0), image_size=(16, 16))
    j_video = jdm.default_video_embedder(jax.random.PRNGKey(0), image_size=(16, 16))
    image = dm.default_image_embedder(device="cpu")
    video = dm.default_video_embedder(device="cpu")
    got, ref = image(images), j_image(images)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    clips = np.stack([images[:3], images[3:], generated[:3]])
    got, ref = video(clips), j_video(clips)
    assert got.shape == (3, 1024)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())

    for make, jmake, data in ((dm.IncrementalFID, jdm.IncrementalFID, (images, generated)),
                              (dm.IncrementalFVD, jdm.IncrementalFVD,
                               (np.stack([images[:3], images[3:]]), np.stack([generated[:3], generated[3:]])))):
        port, jax_side = make(image if make is dm.IncrementalFID else video), jmake(
            j_image if make is dm.IncrementalFID else j_video)
        for accumulator in (port, jax_side):
            accumulator.update_reference(data[0])
            accumulator.update_generated(data[1])
        np.testing.assert_allclose(port.compute(), jax_side.compute(), rtol=1e-3)
    with pytest.raises(ValueError):
        dm.IncrementalFrechet(image).compute()

    vgg3 = port_vgg(3)
    jnet = jperceptual.VGGFeatures(jperceptual.VGG19_PLAN, jperceptual.VGG19_CUTS[:3])
    ref = jperceptual.vgg_cosine_similarity(jnet.apply(jvars, jnp.asarray(images)),
                                            jnet.apply(jvars, jnp.asarray(generated)))
    with torch.no_grad():
        got = vgg_cosine_similarity(vgg3(torch.from_numpy(images)), vgg3(torch.from_numpy(generated)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def inception_variables():
    """Seeded values on jax.eval_shape's tree of InceptionV3Features at
    128x128 (a compiled init costs ~20 s here): lecun-scaled kernels, batch
    norms near identity."""
    net = jinception.InceptionV3Features()
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    rng = np.random.default_rng(1)

    def leaf(path, shape):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=shape.shape) / np.sqrt(np.prod(shape.shape[:3]))).astype(np.float32)
        if name == "var":
            return (1.0 + np.abs(rng.normal(size=shape.shape))).astype(np.float32)
        scale = 1.0 if name == "scale" else 0.0
        return (scale + 0.1 * rng.normal(size=shape.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_inception_matches_jax(tmp_path):
    """InceptionV3 through inception_image_embedder at 128x128 from a
    larger (resize down, antialiased) and a smaller (resize up) input: 1e-4
    of the largest feature; the resize alone at 1e-5; the npz loader's tree
    equal to JAX's."""
    variables = inception_variables()
    net = jinception.InceptionV3Features()
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(variables)}
    # One kernel in torch's (out, in, h, w) layout: the loader transposes it.
    torch_layout = "Mixed_5b/b1b/conv/kernel"
    archive = {k.split("/", 1)[1]: (np.transpose(v, (3, 2, 0, 1)) if k.endswith(torch_layout) else v)
               for k, v in flat.items()}
    np.savez(tmp_path / "inception.npz", **archive)
    loaded = inception_v3.load_inception_params_npz(str(tmp_path / "inception.npz"))
    ref_loaded = jax.device_get(jinception.load_inception_params_npz(str(tmp_path / "inception.npz")))
    assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(ref_loaded)
    for got, ref in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(ref_loaded)):
        np.testing.assert_array_equal(got, ref)

    port = inception_v3.InceptionV3Features(device="cpu")
    load_inception(port, loaded)
    embed = inception_v3.inception_image_embedder(port.requires_grad_(False).eval(), resize_to=128)
    rng = np.random.default_rng(4)
    inputs, resized = [], []
    for shape in ((2, 150, 170, 3), (2, 100, 90, 3)):
        inputs.append(rng.uniform(size=shape).astype(np.float32))
        resized.append(np.asarray(jax.image.resize(jnp.asarray(inputs[-1]), (2, 128, 128, 3), "bilinear")))
        np.testing.assert_allclose(inception_v3.resize_bilinear(torch.from_numpy(inputs[-1]), (128, 128)).numpy(),
                                   resized[-1], rtol=0, atol=1e-5)
    # One compile: JAX's network on both resized batches at once.
    refs = np.asarray(jax.jit(net.apply, compiler_options=NO_OPT)(variables, jnp.asarray(np.concatenate(resized))))
    for images, ref in zip(inputs, (refs[:2], refs[2:])):
        got = embed(images)
        assert got.shape == (2, 2048) and np.abs(ref).max() > 0.1
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max(), err_msg=str(images.shape))


class MatplotlibRecorder:
    """Records what the JAX plotting module hands matplotlib's Axes."""

    METHODS = ("hist", "hist2d", "scatter", "annotate", "set_xlim", "set_ylim")

    def __init__(self, monkeypatch):
        import matplotlib.axes

        self.calls = []
        for name in self.METHODS:
            original = getattr(matplotlib.axes.Axes, name)

            def wrapped(ax, *args, _name=name, _original=original, **kwargs):
                out = _original(ax, *args, **kwargs)
                self.calls.append((_name, args, kwargs, out))
                return out

            monkeypatch.setattr(matplotlib.axes.Axes, name, wrapped)

    def pop(self, name):
        found = [c for c in self.calls if c[0] == name]
        self.calls = [c for c in self.calls if c[0] != name]
        return found


def test_plotting_arrays_match_what_jax_plots(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    actions = rng.integers(0, 3, 40)  # action 3 of 4 never taken
    movements = rng.normal(0, 0.02, (40, 2)) + np.stack([np.cos(actions), np.sin(actions)], -1) * 0.03
    recorder = MatplotlibRecorder(monkeypatch)

    jplotting.plot_density_1d(actions, np.linalg.norm(movements, axis=-1), 4, str(tmp_path / "jax" / "m.png"))
    hists = recorder.pop("hist")
    port_hists = plotting.density_1d_histograms(actions, np.linalg.norm(movements, axis=-1), 4)
    assert [h is None for h in port_hists] == [False, False, False, True] and len(hists) == 3
    for (_, args, kwargs, out), (density, edges) in zip(hists, [h for h in port_hists if h is not None]):
        np.testing.assert_array_equal(out[0], density)
        np.testing.assert_array_equal(out[1], edges)

    jplotting.plot_density_2d(actions, movements, 4, str(tmp_path / "jax"), prefix="world_")
    hists2d = recorder.pop("hist2d")
    port_2d = plotting.density_2d_histograms(actions, movements, 4)
    assert len(hists2d) == 3 and port_2d[3] is None
    for (_, _, _, out), (counts, xedges, yedges) in zip(hists2d, port_2d[:3]):
        for got, ref in zip((counts, xedges, yedges), out[:3]):
            np.testing.assert_array_equal(got, ref)
    xlim, ylim = plotting.density_2d_limits(actions, movements)
    assert hists2d[0][2]["range"] == [xlim, ylim]

    recorder.calls.clear()
    jplotting.plot_density_2d(actions, movements, 4, str(tmp_path / "jax"), prefix="world_", merged=True)
    scatters, limits = recorder.pop("scatter"), (recorder.pop("set_xlim"), recorder.pop("set_ylim"))
    points = plotting.merged_points(actions, movements, 4)
    assert points[3] is None and len(scatters) == 3
    for (_, args, _, _), sel in zip(scatters, points[:3]):
        np.testing.assert_array_equal(np.stack([args[0], args[1]], -1), sel)
    explicit = [[c[1] for c in found if len(c[1]) == 2] for found in limits]  # the module's set_*lim(lo, hi)
    assert explicit == [[xlim], [ylim]]

    recorder.calls.clear()
    jplotting.plot_mean_vectors_2d(actions, movements, 4, str(tmp_path / "jax"), prefix="world_")
    arrows, lim = recorder.pop("annotate"), recorder.pop("set_xlim")
    means, port_lim = plotting.mean_vectors(actions, movements, 4)
    np.testing.assert_array_equal(np.asarray([a[2]["xy"] for a in arrows]), means)
    assert [c[1] for c in lim if len(c[1]) == 2] == [(-port_lim, port_lim)]

    port_dir = tmp_path / "port"
    plotting.plot_density_2d(actions, movements, 4, str(port_dir), prefix="world_")
    plotting.plot_density_2d(actions, movements, 4, str(port_dir), prefix="world_", merged=True)
    plotting.plot_mean_vectors_2d(actions, movements, 4, str(port_dir), prefix="world_")
    plotting.plot_density_1d(actions, np.linalg.norm(movements, axis=-1), 4, str(port_dir / "m.png"))
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    from PIL import Image

    for name in names:
        with Image.open(port_dir / name) as image:
            assert image.size[0] > 300 and len(np.unique(np.asarray(image).reshape(-1, 3), axis=0)) > 1, name
