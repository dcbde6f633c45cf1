"""The port's CUDA kernels on a card (marker `cuda`; skipped without one).

Imports neither JAX nor the JAX package, so that it runs where only PyTorch
is installed, without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pathlib

import numpy as np
import pytest
import torch

from playableenvironments_tpu_torch.cli.play import InteractiveSession
from playableenvironments_tpu_torch.config import NerfMLPConfig, PositionalEncoderConfig, scene_from_yaml
from playableenvironments_tpu_torch.models.encoding import positional_encoding
from playableenvironments_tpu_torch.models.layers import initialize_
from playableenvironments_tpu_torch.models.nerf import AdaInNerfMLP
from playableenvironments_tpu_torch.ops import fused_nerf
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is CUDA C++ for sm_90a and has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rays,samples", [(4320, 4), (1440, 32), (37, 3)])
def test_kernel_matches_plain_on_the_card(card, rays, samples):
    """Tennis widths (8x256, 63 -> 192): the kernel against its plain
    version on the same card, including a ragged last tile, and the launch
    counted once."""
    cfg = NerfMLPConfig()
    nerf = initialize_(AdaInNerfMLP(cfg, 64, device=card), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    encoded = positional_encoding(torch.rand(rays * samples, 3, generator=g) * 2 - 1, 10, True).to(card)
    style = torch.randn(rays, 64, generator=g).to(card)
    with torch.no_grad():
        mods = [*fused_nerf.fold_adain_stats(nerf.adain_0, style), *fused_nerf.fold_adain_stats(nerf.adain_1, style)]
        before = fused_nerf.fused_adain_nerf.launches
        got = fused_nerf.fused_adain_nerf(cfg, nerf.kernel_weights(), encoded, *mods, samples_per_ray=samples)
        torch.cuda.synchronize()
        assert fused_nerf.fused_adain_nerf.launches == before + 1
        ref = fused_nerf.plain_adain_nerf(cfg, nerf.kernel_weights().packed, encoded, *mods, samples)
    for g_, r in zip(got, ref):
        diff = (g_ - r).abs()
        # chip_smoke.py states these bounds and why.
        assert bool((diff <= 3e-2 + 1e-2 * r.abs()).all()) and diff.mean().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("width", [256, 128])
def test_grouped_kernel_matches_plain_on_the_card(card, width):
    """The tennis frame's four objects and a ragged one (odd tile count),
    each with its own weights, in one grouped launch, each object against
    its plain version; then the same group twice, bit-identical."""
    cfg = NerfMLPConfig(layers_width=width)
    specs = [(4320, 4), (11520, 4), (1440, 32), (1440, 32), (37, 3)]
    g = torch.Generator().manual_seed(1)
    items = []
    for i, (rays, samples) in enumerate(specs):
        nerf = initialize_(AdaInNerfMLP(cfg, 64, device=card), torch.Generator().manual_seed(10 + i))
        encoded = positional_encoding(torch.rand(rays * samples, 3, generator=g) * 2 - 1, 10, True).to(card)
        style = torch.randn(rays, 64, generator=g).to(card)
        with torch.no_grad():
            mods = [*fused_nerf.fold_adain_stats(nerf.adain_0, style),
                    *fused_nerf.fold_adain_stats(nerf.adain_1, style)]
        items.append(fused_nerf.AdaInNerfItem(nerf.kernel_weights(), encoded, *mods, samples))
    before = (fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects)
    with torch.no_grad():
        got = fused_nerf.fused_adain_nerf_group(cfg, items)
        again = fused_nerf.fused_adain_nerf_group(cfg, items)
        torch.cuda.synchronize()
        assert (fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects) == (
            before[0] + 2, before[1] + 2 * len(items))
        for item, out, out_again in zip(items, got, again):
            ref = fused_nerf.plain_adain_nerf(cfg, item.weights.packed, *item[1:6], item.samples_per_ray)
            for g_, g2, r in zip(out, out_again, ref):
                assert torch.equal(g_, g2)
                diff = (g_ - r).abs()
                assert bool((diff <= 3e-2 + 1e-2 * r.abs()).all()) and diff.mean().item() <= 1e-4


@pytest.mark.cuda
def test_kernel_rejects_what_its_layout_does_not_take(card):
    cfg = NerfMLPConfig(layers_width=192)
    nerf = AdaInNerfMLP(cfg, 64, device=card)
    mods = [torch.zeros(2, 192, device=card), torch.zeros(2, 192, device=card),
            torch.zeros(2, 96, device=card), torch.zeros(2, 96, device=card)]
    with pytest.raises(ValueError, match="takes"):
        fused_nerf.fused_adain_nerf(cfg, nerf.kernel_weights(), torch.zeros(8, 63, device=card), *mods,
                                    samples_per_ray=4)


@pytest.mark.cuda
def test_kernel_rejects_host_modulation(card):
    cfg = NerfMLPConfig()
    nerf = AdaInNerfMLP(cfg, 64, device=card)
    mods = [torch.zeros(2, 256), torch.zeros(2, 256), torch.zeros(2, 128), torch.zeros(2, 128)]
    with pytest.raises(ValueError, match="must be on"):
        fused_nerf.fused_adain_nerf(cfg, nerf.kernel_weights(), torch.zeros(8, 63, device=card), *mods, samples_per_ray=4)


@pytest.mark.cuda
def test_session_on_the_card_launches_the_kernel_per_object(card):
    """Tennis at 48x64: the frame's 4 objects in one grouped launch per
    frame, and the frames match the same seeded session on the CPU."""
    scene = scene_from_yaml(str(REPO / "configs" / "tennis.yaml"))
    small = dict(image_size=(48, 64), patch_strides=(4, 8), focal_length_multiplier=0.51417 * 64 / 512)
    card_session = InteractiveSession.from_scene(scene, device=card, **small)
    host_session = InteractiveSession.from_scene(scene, device="cpu", **small)
    n = 4
    translations = torch.zeros(1, 1, n, 3)
    translations[:, :, 2, 1] = -5.0
    translations[:, :, 3, 1] = -10.0
    encoding = SceneEncoding(
        torch.tensor([[[[-0.15, 0.0, 0.0]]]]), torch.tensor([[[[0.0, -30.0, 10.0]]]]),
        torch.full((1, 1, 1), 600.0), torch.zeros(1, 1, n, 3), translations,
        torch.ones(1, 1, n, 64) * 0.1, torch.ones(1, 1, n, 32) * 0.1, torch.ones(1, 1, n, dtype=torch.bool),
    )
    before = (fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects)
    frames = [(card_session.start(encoding), host_session.start(encoding))]
    frames.append((card_session.step([1, 2]), host_session.step([1, 2])))
    assert (fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects) == (before[0] + 2, before[1] + 8)
    for got, ref in frames:
        np.testing.assert_allclose(got, ref, atol=1e-2)


BACKBONE = NerfMLPConfig(output_features=3, compute_dtype="bfloat16", use_fused_backbone=True,
                         position_encoder=PositionalEncoderConfig(octaves=10))
# The wgmma width and the ring's slot size follow layers_width.
NARROW = {
    128: NerfMLPConfig(layers_width=128, backbone_layers_count=6, skip_layer_idx=3, output_features=3,
                       compute_dtype="bfloat16", use_fused_backbone=True,
                       position_encoder=PositionalEncoderConfig(octaves=10)),
    64: NerfMLPConfig(layers_width=64, backbone_layers_count=4, skip_layer_idx=2, output_features=3,
                      compute_dtype="bfloat16", use_fused_backbone=True,
                      position_encoder=PositionalEncoderConfig(octaves=4)),
}


def backbone_inputs(card, points, seed=1, cfg=BACKBONE):
    nerf = initialize_(AdaInNerfMLP(cfg, 64, device=card), torch.Generator().manual_seed(0))
    packed = {k: v.detach().contiguous() for k, v in nerf.backbone_params().items()}
    g = torch.Generator().manual_seed(seed)
    octaves = cfg.position_encoder.octaves
    encoded = positional_encoding(torch.rand(points, 3, generator=g) * 2 - 1, octaves, True).to(card)
    g_h = (torch.randn(points, cfg.layers_width, generator=g) * 1e-3).to(card)
    g_alpha = (torch.randn(points, generator=g) * 1e-3).to(card)
    return packed, encoded, g_h, g_alpha


@pytest.mark.cuda
@pytest.mark.parametrize("points,width", [(18432, 256), (1000, 256), (37, 256), (1000, 128), (37, 128), (1000, 64)])
def test_backbone_kernels_match_plain_on_the_card(card, points, width):
    """B2 and B3 against their plain versions on the same card, at the
    tennis widths (8x256, encoding 63) and narrower ones, a ragged last tile
    and a launch of less than one 128-point tile included, B3 bit-identical
    across launches, each launch counted once."""
    cfg = BACKBONE if width == 256 else NARROW[width]
    packed, encoded, g_h, g_alpha = backbone_inputs(card, points, cfg=cfg)
    before = (fused_nerf.fused_backbone_fwd.launches, fused_nerf.fused_backbone_bwd.launches)
    with torch.no_grad():
        got = fused_nerf.fused_backbone_fwd(cfg, packed, encoded)
        grads, d_encoded = fused_nerf.fused_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
        again, d_encoded_again = fused_nerf.fused_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
        torch.cuda.synchronize()
        ref = fused_nerf.plain_backbone_fwd(cfg, packed, encoded)
        ref_grads, ref_d_encoded = fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
    assert (fused_nerf.fused_backbone_fwd.launches, fused_nerf.fused_backbone_bwd.launches) == (before[0] + 1, before[1] + 2)
    assert torch.equal(d_encoded, d_encoded_again) and all(torch.equal(grads[k], again[k]) for k in grads)
    for g_, r in zip(got, ref):  # chip_smoke.py states these bounds and why
        diff = (g_ - r).abs()
        assert bool((diff <= 3e-2 + 1e-2 * r.abs()).all()) and diff.mean().item() <= 1e-4
    for name, g_, r, tol, mean_tol in [("d_encoded", d_encoded, ref_d_encoded, 0.5, 1e-3)] + [
            (k, grads[k], ref_grads[k], 5e-2, 1e-2) for k in ref_grads]:
        scale = r.abs().max().item()
        diff = (g_ - r).abs()
        assert diff.max().item() <= tol * scale and diff.mean().item() <= mean_tol * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("points,width", [(131072, 256), (1000, 128)])
def test_backbone_backward_within_its_rounding_scale_on_the_card(card, points, width):
    """B3 against the f64 backward at the kernels' own layer outputs
    (backbone_layer_outputs: B2 over the first layers, one launch each),
    with cotangents of 1e-8 and random signs, so that weight gradients
    cancel: every output within 2^-6 of each element's rounding scale and
    2^-12 of it in the mean (chip_smoke.py's BF16_GRAD_BAND, which says
    why), while its largest-magnitude reading says nothing."""
    cfg = BACKBONE if width == 256 else NARROW[width]
    packed, encoded, g_h, g_alpha = backbone_inputs(card, points, seed=2, cfg=cfg)
    g_h, g_alpha = g_h * 1e-5, g_alpha * 1e-5
    before = fused_nerf.fused_backbone_fwd.launches
    with torch.no_grad():
        grads, d_encoded = fused_nerf.fused_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
        acts = [x.double() for x in fused_nerf.backbone_layer_outputs(cfg, packed, encoded)]
        f64 = ({k: v.double() for k, v in packed.items()}, encoded.double(), g_h.double(), g_alpha.double())
        ref_grads, ref_d_encoded = fused_nerf.plain_backbone_bwd(cfg, *f64, acts=acts)
        scales, d_encoded_scale = fused_nerf.plain_backbone_bwd(cfg, *f64, acts=acts, magnitudes=True)
    assert fused_nerf.fused_backbone_fwd.launches == before + cfg.backbone_layers_count
    outputs = [("d_encoded", d_encoded, ref_d_encoded, d_encoded_scale)] + [
        (k, grads[k], ref_grads[k], scales[k]) for k in ref_grads]
    for name, got, ref, scale in outputs:
        worst, mean = fused_nerf.rounding_error_ratio(got, ref, scale)
        assert worst <= 2.0 ** -6 and mean <= 2.0 ** -12, (name, worst, mean)


@pytest.mark.cuda
def test_backbone_kernels_refuse_float32_operands(card):
    """The f32 kernels take widths 64, 128 and 256 and raise for others;
    operand dtypes with no kernel (float16) raise."""
    cfg = F32_BACKBONE[256]
    odd = NerfMLPConfig(layers_width=192, output_features=3, compute_dtype="float32", use_fused_backbone=True,
                        position_encoder=PositionalEncoderConfig(octaves=10))
    packed, encoded, g_h, g_alpha = backbone_inputs(card, 64, cfg=odd)
    with pytest.raises(ValueError, match="f32 backbone kernels take widths"):
        fused_nerf.fused_backbone_fwd(odd, packed, encoded)
    with pytest.raises(ValueError, match="f32 backbone kernels take widths"):
        fused_nerf.fused_backbone_bwd(odd, packed, encoded, g_h, g_alpha)
    half = NerfMLPConfig(output_features=3, compute_dtype="float16", use_fused_backbone=True)
    packed, encoded, g_h, g_alpha = backbone_inputs(card, 64, cfg=cfg)
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        fused_nerf.fused_backbone_fwd(half, packed, encoded)
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        fused_nerf.fused_backbone_bwd(half, packed, encoded, g_h, g_alpha)


F32_BACKBONE = {
    256: NerfMLPConfig(output_features=3, compute_dtype="float32", use_fused_backbone=True,
                       position_encoder=PositionalEncoderConfig(octaves=10)),
    128: NerfMLPConfig(layers_width=128, backbone_layers_count=6, skip_layer_idx=3, output_features=3,
                       compute_dtype="float32", use_fused_backbone=True,
                       position_encoder=PositionalEncoderConfig(octaves=10)),
    64: NerfMLPConfig(layers_width=64, backbone_layers_count=4, skip_layer_idx=0, output_features=3,
                      compute_dtype="float32", use_fused_backbone=True,
                      position_encoder=PositionalEncoderConfig(octaves=4)),
}


# chip_smoke.py's bounds on the f32 kernels' ReLU pattern against the f64
# forward's (phase 14a): pre-activation errors and units on the other side
# within 2^-16 of their rounding scale, at most 1 such unit a million of a
# layer's, 4 at least.
F32_RELU_BAND = 2.0 ** -16
F32_RELU_FLIPS, F32_RELU_FLIPS_FLOOR = 1.0, 4


@pytest.mark.cuda
@pytest.mark.parametrize("points,width", [(18432, 256), (70001, 256), (37, 256), (1000, 128), (1000, 64)])
def test_backbone_f32_kernels_match_plain_on_the_card(card, points, width):
    """B2 and B3 for f32 operands (csrc/fused_backbone_f32.cu) on the same
    card: the tennis widths, a launch of two backward chunks with a ragged
    last tile, less than one tile, narrower widths (64 without a skip
    layer). B2 against the plain f32 version, and each layer's ReLU pattern
    against the f64 forward's (relu_pattern_check); B3 against the plain
    backward in f64 at that pattern (chip_smoke.py phase 14a says why: the
    plain f32 version takes a few ReLUs whose input lies within f32 rounding
    of 0 on the other side). Each output within 1e-3 of its largest
    magnitude and 1e-5 of it in the mean (14a states the measured errors),
    B3 bit-identical across launches, each launch counted once."""
    cfg = F32_BACKBONE[width]
    packed, encoded, g_h, g_alpha = backbone_inputs(card, points, cfg=cfg)
    before = (fused_nerf.backbone_f32_fwd.launches, fused_nerf.backbone_f32_bwd.launches)
    with torch.no_grad():
        got = fused_nerf.fused_backbone_fwd(cfg, packed, encoded)
        grads, d_encoded = fused_nerf.fused_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
        again, d_encoded_again = fused_nerf.fused_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
        torch.cuda.synchronize()
        launches = (fused_nerf.backbone_f32_fwd.launches, fused_nerf.backbone_f32_bwd.launches)
        ref = fused_nerf.plain_backbone_fwd(cfg, packed, encoded)
        masks, pattern = fused_nerf.relu_pattern_check(
            cfg, packed, encoded, fused_nerf.backbone_layer_outputs(cfg, packed, encoded))
        ref_grads, ref_d_encoded = fused_nerf.plain_backbone_bwd(
            cfg, {k: v.double() for k, v in packed.items()}, encoded.double(), g_h.double(), g_alpha.double(), masks)
    assert launches == (before[0] + 1, before[1] + 2)
    flip_limit = max(F32_RELU_FLIPS_FLOOR, F32_RELU_FLIPS * points * width / 1e6)
    for layer, r in enumerate(pattern):
        assert r["flips"] <= flip_limit, (layer, r)
        assert r["flip_ratio"] <= F32_RELU_BAND and r["error_ratio"] <= F32_RELU_BAND, (layer, r)
    assert torch.equal(d_encoded, d_encoded_again) and all(torch.equal(grads[k], again[k]) for k in grads)
    outputs = [("h", got[0], ref[0]), ("alpha", got[1], ref[1]), ("d_encoded", d_encoded, ref_d_encoded)]
    for name, g_, r in outputs + [(k, grads[k], ref_grads[k]) for k in ref_grads]:
        r = r.reshape(g_.shape).to(g_.dtype)
        scale = r.abs().max().item()
        diff = (g_ - r).abs()
        assert diff.max().item() <= 1e-3 * scale and diff.mean().item() <= 1e-5 * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("width,strided", [(256, False), (256, True), (128, False), (64, True)])
def test_backbone_f32_images_match_their_plain_version_on_the_card(card, width, strided):
    """The card's pack kernel builds the f32 kernels' 3xTF32 weight images,
    biases and w_alpha bit for bit as plain_backbone_f32_buffers does on
    the CPU, from contiguous weights or the modules' transposed views, in
    one counted launch."""
    cfg = F32_BACKBONE[width]
    nerf = initialize_(AdaInNerfMLP(cfg, 64, device=card), torch.Generator().manual_seed(3))
    packed = {k: v.detach() for k, v in nerf.backbone_params().items()}
    if not strided:
        packed = {k: v.contiguous() for k, v in packed.items()}
    before = fused_nerf.backbone_f32_buffers.launches
    got = fused_nerf.backbone_f32_buffers(cfg, packed)
    ref = fused_nerf.plain_backbone_f32_buffers(cfg, {k: v.cpu() for k, v in packed.items()})
    assert fused_nerf.backbone_f32_buffers.launches == before + 1
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a.cpu(), b), name


@pytest.mark.cuda
def test_fused_backbone_autograd_keeps_f32_encodings_for_the_f32_kernels(card):
    """An f32 NeRF with the fused backbone launches B2 and B3 for f32
    operands through the autograd Function, and none of the bf16 kernels."""
    cfg = F32_BACKBONE[256]
    packed, encoded, g_h, g_alpha = backbone_inputs(card, 500, cfg=cfg)
    packed = {k: v.requires_grad_() for k, v in packed.items()}
    encoded.requires_grad_()
    before = [fused_nerf.backbone_f32_fwd.launches, fused_nerf.backbone_f32_bwd.launches,
              fused_nerf.fused_backbone_fwd.launches, fused_nerf.fused_backbone_bwd.launches]
    h, alpha = fused_nerf.fused_backbone(cfg, packed, encoded)
    torch.autograd.backward([h, alpha], [g_h, g_alpha])
    after = [fused_nerf.backbone_f32_fwd.launches, fused_nerf.backbone_f32_bwd.launches,
             fused_nerf.fused_backbone_fwd.launches, fused_nerf.fused_backbone_bwd.launches]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0, 0]
    ref_grads, ref_d = fused_nerf.plain_backbone_bwd(cfg, {k: v.detach() for k, v in packed.items()},
                                                     encoded.detach(), g_h, g_alpha)
    assert (encoded.grad - ref_d).abs().max().item() <= 1e-3 * ref_d.abs().max().item()


@pytest.mark.cuda
def test_fused_backbone_autograd_launches_both_kernels(card):
    packed, encoded, g_h, g_alpha = backbone_inputs(card, 500)
    params = {k: v.clone().requires_grad_() for k, v in packed.items()}
    before = (fused_nerf.fused_backbone_fwd.launches, fused_nerf.fused_backbone_bwd.launches)
    h, alpha = fused_nerf.fused_backbone(BACKBONE, params, encoded.requires_grad_())
    torch.autograd.backward([h, alpha], [g_h, g_alpha])
    torch.cuda.synchronize()
    assert (fused_nerf.fused_backbone_fwd.launches, fused_nerf.fused_backbone_bwd.launches) == (before[0] + 1, before[1] + 1)
    grads, d_encoded = fused_nerf.fused_backbone_bwd(BACKBONE, packed, encoded.detach(), g_h, g_alpha)
    assert torch.equal(encoded.grad, d_encoded)
    for name, p in params.items():
        assert torch.equal(p.grad, grads[name].reshape(p.shape)), name


def rollout_setup(card, batch, T, cfg, seed):
    """chip_smoke.py's rollout case: seeded phase-3 dynamics (2 x 256) and inputs."""
    sys_path_repo()
    import chip_smoke

    box = ((-0.75, 0.75), (-0.5, 0.5), (0.0, 2.15))
    return chip_smoke.rollout_case(chip_smoke.phase3_animation_config(), box, batch, T, seed, card)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,T,axis,force_rot,forced,gt", [
    (16, 9, 2, True, 0.0, 5), (5, 6, 2, True, 0.0, 3), (5, 6, 1, False, None, 1), (5, 6, 0, False, 0.01, 0),
    (33, 9, 2, True, 0.0, 5), (33, 6, 1, False, None, 2)])
def test_rollout_kernels_match_plain_on_the_card(card, batch, T, axis, force_rot, forced, gt):
    """B4 and B5 at the phase-3 shape, a ragged batch in each branch of
    RolloutConfig and a batch of 33 (three clusters, the last ragged)
    against their plain versions on the same card (1e-4 of
    each output's largest magnitude, chip_smoke.py states why), B5
    bit-identical across launches, each launch counted once."""
    from playableenvironments_tpu_torch.ops import fused_rollout as fr

    cfg = fr.RolloutConfig(axis, force_rot, forced, (1.5, 1.0, 2.15))
    packed, inputs, cots = rollout_setup(card, batch, T, cfg, seed=batch + T + axis)
    before = (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches)
    with torch.no_grad():
        out, res = fr.fused_rollout_fwd(cfg, packed, *inputs, gt, True)
        grads = fr.fused_rollout_bwd(cfg, packed, gt, res, cots, 7)
        again = fr.fused_rollout_bwd(cfg, packed, gt, res, cots, 7)
        torch.cuda.synchronize()
        ref_out, ref_res = fr.plain_rollout_fwd(cfg, packed, *inputs, gt, True)
        ref_grads = fr.plain_rollout_bwd(cfg, packed, gt, ref_res, cots, 7)
    assert (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches) == (before[0] + 1, before[1] + 2)
    flat = lambda g: fr.param_list(g[0]) + list(g[1:])  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(grads), flat(again)))
    pairs = list(zip(out, ref_out)) + [(res[k], ref_res[k]) for k in ref_res] + list(zip(flat(grads), flat(ref_grads)))
    for got, ref in pairs:
        scale = ref.abs().max().item()
        diff = (got - ref).abs()
        assert diff.max().item() <= 1e-4 * scale and diff.mean().item() <= 1e-5 * scale


@pytest.mark.cuda
def test_rollout_autograd_launches_both_kernels(card):
    from playableenvironments_tpu_torch.ops import fused_rollout as fr

    cfg = fr.RolloutConfig(2, True, 0.0, (1.5, 1.0, 2.15))
    packed, inputs, cots = rollout_setup(card, 16, 9, cfg, seed=1)
    leaves = [p.clone().requires_grad_() for p in fr.param_list(packed)]
    actions = inputs[4].clone().requires_grad_()
    before = (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches)
    out = fr.fused_rollout(cfg, fr.params_from_list(leaves, 2), *inputs[:4], actions, inputs[5], 5)
    torch.autograd.backward(list(out), cots)
    with torch.no_grad():
        fr.fused_rollout(cfg, packed, *inputs, 5)
    torch.cuda.synchronize()
    assert (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches) == (before[0] + 2, before[1] + 1)
    _, res = fr.fused_rollout_fwd(cfg, packed, *inputs, 5, True)
    grads = fr.fused_rollout_bwd(cfg, packed, 5, res, cots, 7)
    for leaf, g in zip(leaves, fr.param_list(grads[0])):
        assert torch.equal(leaf.grad, g)
    assert torch.equal(actions.grad, grads[5])


@pytest.mark.cuda
def test_rollout_kernels_refuse_unsupported_shapes(card):
    from playableenvironments_tpu_torch.ops import fused_rollout as fr

    cfg = fr.RolloutConfig(2, True, 0.0, (1.5, 1.0, 2.15))
    packed, inputs, _ = rollout_setup(card, 4, 5, cfg, seed=2)
    with pytest.raises(ValueError, match="float32"):
        fr.fused_rollout_fwd(cfg, packed, inputs[0].double(), *inputs[1:], 3, False)
    with pytest.raises(ValueError, match="at least 2 observations"):
        fr.fused_rollout_fwd(cfg, packed, *(x[:, :1] for x in inputs[:4]), *(x[:, :0] for x in inputs[4:]), 0, False)
    wide = packed._replace(wb=torch.zeros(48, 48, device=card))
    with pytest.raises(ValueError, match="multiple of 32"):
        fr.fused_rollout_fwd(cfg, wide, *inputs, 3, False)


def sys_path_repo():
    """chip_smoke.py lives at the repository's root."""
    import sys

    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))


@pytest.mark.cuda
def test_rollout_gradients_reach_the_dynamics_network_on_the_card(card):
    """Through pack_dynamics_params, whose backbone weight is a transposed
    view (B5 once returned its gradient transposed for it): the card's
    parameter gradients against the same module's on the CPU."""
    import copy

    from playableenvironments_tpu_torch.models.dynamics import DynamicsNetwork
    from playableenvironments_tpu_torch.models.layers import initialize_
    from playableenvironments_tpu_torch.ops import fused_rollout as fr

    sys_path_repo()
    import chip_smoke

    anim = chip_smoke.phase3_animation_config()
    box = ((-0.75, 0.75), (-0.5, 0.5), (0.0, 2.15))
    cfg = fr.RolloutConfig(2, True, 0.0, (1.5, 1.0, 2.15))
    host = initialize_(DynamicsNetwork(anim, box), torch.Generator().manual_seed(4))
    device_net = copy.deepcopy(host).to(card)
    _, inputs, cots = rollout_setup("cpu", 16, 9, cfg, seed=5)
    assert not fr.pack_dynamics_params(host).wb.is_contiguous()
    grads = []
    for net, device in ((device_net, card), (host, "cpu")):
        out = fr.fused_rollout(cfg, fr.pack_dynamics_params(net), *(x.to(device) for x in inputs), 5)
        torch.autograd.backward(list(out), [c.to(device) for c in cots])
        grads.append({n: p.grad.cpu() for n, p in net.named_parameters()})
    for name, ref in grads[1].items():
        scale = ref.abs().max().item()
        assert (grads[0][name] - ref).abs().max().item() <= 1e-4 * scale, name


@pytest.mark.cuda
def test_rollout_kernel_takes_the_reference_atan2(card):
    """The rotation delta at the pairs where the reference's atan formula
    and atan2f part (s = -0.0 with c < 0, a tiny negative c): the head's
    rotation columns zeroed so that its bias is every step's (sin, cos)."""
    from playableenvironments_tpu_torch.ops import fused_rollout as fr

    cfg = fr.RolloutConfig(1, False, None, (1.5, 1.0, 2.15))
    packed, inputs, _ = rollout_setup(card, 5, 6, cfg, seed=3)
    for s, c in ((-0.0, -1.0), (1.0, -1e-25), (-1.0, -1e-25)):
        whead, bhead = packed.whead.clone(), packed.bhead.clone()
        whead[:, 2:4] = 0.0
        bhead[0, 2], bhead[0, 3] = s, c
        params = packed._replace(whead=whead, bhead=bhead)
        with torch.no_grad():
            got = fr.fused_rollout_fwd(cfg, params, *inputs, 1, False)[0][0]
            ref = fr.plain_rollout_fwd(cfg, params, *inputs, 1, False)[0][0]
        assert (got - ref).abs().max().item() <= 1e-5, (s, c)


SMALL = dict(image_size=(48, 64), patch_strides=(4, 8), focal_length_multiplier=0.51417 * 64 / 512)


def small_dataset(root, frames_by_split):
    """chip_smoke.py phase 11's dataset at 48x64."""
    from playableenvironments_tpu_torch.data.synthetic import make_two_player_dataset

    sys_path_repo()
    import chip_smoke

    make_two_player_dataset(root, height=48, width=64, focal=chip_smoke.DATA_FOCAL,
                            focal_length_multiplier=SMALL["focal_length_multiplier"],
                            camera_rotation=chip_smoke.DATA_CAMERA[0], camera_translation=chip_smoke.DATA_CAMERA[1],
                            player_ranges=chip_smoke.DATA_PLAYERS, splits=tuple(frames_by_split),
                            frames_by_split=frames_by_split)
    return root


@pytest.mark.cuda
def test_play_from_a_batch_on_the_card(card, tmp_path):
    """Tennis at 48x64: initialize(batch) and a step, one grouped B1 launch
    of 4 objects a frame, the frames as the same seeded session's on the
    CPU."""
    from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset

    root = small_dataset(str(tmp_path), {"test": (1, 3)})
    batch = next(MulticameraVideoDataset(f"{root}/test", observations_count=1).iterate_batches(1, shuffle=False))
    scene = scene_from_yaml(str(REPO / "configs" / "tennis.yaml"))
    card_session = InteractiveSession.from_scene(scene, device=card, **SMALL)
    host_session = InteractiveSession.from_scene(scene, device="cpu", **SMALL)
    before = (fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects)
    frames = [(card_session.initialize(batch), host_session.initialize(batch))]
    frames.append((card_session.step([1, 2]), host_session.step([1, 2])))
    assert (fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects) == (before[0] + 2, before[1] + 8)
    for got, ref in frames:
        np.testing.assert_allclose(got, ref, atol=1e-2)


@pytest.mark.cuda
def test_reconstruction_at_batch_4_launches_once_a_batch(card, tmp_path):
    """The creator over 6 frames at batch 4: 2 B1 launches of 4 objects, a
    PNG for every frame, a mirror that loads as a dataset."""
    from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
    from playableenvironments_tpu_torch.eval.creators import FrameRenderer, ReconstructedDatasetCreator

    root = small_dataset(str(tmp_path / "data"), {"test": (2, 3)})
    scene = scene_from_yaml(str(REPO / "configs" / "tennis.yaml"))
    session = InteractiveSession.from_scene(scene, device=card, **SMALL)
    renderer = FrameRenderer(session.renderer.model, session.autoencoder, SMALL["image_size"], SMALL["patch_strides"])
    before = (fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects)
    mirror = str(tmp_path / "mirror")
    ReconstructedDatasetCreator(renderer, batch_size=4).reconstruct_dataset(
        MulticameraVideoDataset(f"{root}/test", observations_count=1), mirror)
    assert (fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects) == (before[0] + 2, before[1] + 8)
    assert len(list(pathlib.Path(mirror).rglob("*.png"))) == 6
    assert len(MulticameraVideoDataset(mirror, observations_count=1)) == 6


@pytest.mark.cuda
def test_step_with_batch_launches_the_rollout_kernels(card, tmp_path):
    """phase 3 from a dataset batch (bs 2 x 9 at 48x64) on the card: the
    frozen encoding, then 4 B4 and 2 B5 launches, finite losses."""
    from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
    from playableenvironments_tpu_torch.ops import fused_rollout as fr
    from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
    from playableenvironments_tpu_torch.utils.random import RngStreams

    sys_path_repo()
    import chip_smoke

    root = small_dataset(str(tmp_path), {"train": (1, 10)})
    batch = next(MulticameraVideoDataset(f"{root}/train", observations_count=9).iterate_batches(2, shuffle=False))
    env_model = EnvironmentModel(chip_smoke.phase3_scene(), SMALL["focal_length_multiplier"], device=card)
    trainer = chip_smoke.phase3_data_trainer(env_model, card)
    trainer.init_state(batch)
    before = (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches)
    metrics = trainer.step_with_batch(batch, RngStreams(0, card))
    torch.cuda.synchronize()
    assert (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches) == (before[0] + 4, before[1] + 2)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.cuda
def test_minecraft_frame_group_matches_plain_on_the_card(card):
    """The Minecraft frame's B1 launch (configs/minecraft.yaml at 512x288):
    the uncompacted background (11,520 strided-grid rays x 16 samples) and
    two players of one object model (1,440 compacted rays x 32 samples
    each) in one grouped launch, the players' items pointing at one weight
    image; each object against its plain version, counted as one launch of
    3 objects. Bounds as test_kernel_matches_plain_on_the_card, in units of
    the output's mean magnitude where it exceeds 1 (chip_smoke.py phase 11
    states why)."""
    cfg = scene_from_yaml(str(REPO / "configs" / "minecraft.yaml")).object_models[0].nerf
    g = torch.Generator().manual_seed(3)
    background = initialize_(AdaInNerfMLP(cfg, 32, device=card), torch.Generator().manual_seed(20))
    player = initialize_(AdaInNerfMLP(cfg, 32, device=card), torch.Generator().manual_seed(21))
    items = []
    for nerf, rays, samples in ((background, 11520, 16), (player, 1440, 32), (player, 1440, 32)):
        encoded = positional_encoding(torch.rand(rays * samples, 3, generator=g) * 2 - 1, 10, True).to(card)
        style = torch.randn(rays, 32, generator=g).to(card)
        with torch.no_grad():
            mods = [*fused_nerf.fold_adain_stats(nerf.adain_0, style),
                    *fused_nerf.fold_adain_stats(nerf.adain_1, style)]
        items.append(fused_nerf.AdaInNerfItem(nerf.kernel_weights(), encoded, *mods, samples))
    assert items[1].weights.image.data_ptr() == items[2].weights.image.data_ptr()
    before = (fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects)
    with torch.no_grad():
        got = fused_nerf.fused_adain_nerf_group(cfg, items)
        torch.cuda.synchronize()
    assert (fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects) == (
        before[0] + 1, before[1] + 3)
    assert sum(it.encoded.shape[0] for it in items) == 276480
    for item, outputs in zip(items, got):
        with torch.no_grad():
            ref = fused_nerf.plain_adain_nerf(cfg, item.weights.packed, item.encoded, item.scale0, item.bias0,
                                              item.scale1, item.bias1, item.samples_per_ray)
        for g_, r in zip(outputs, ref):
            scale = max(1.0, r.abs().mean().item())
            diff = (g_ - r).abs() / scale
            assert bool((diff <= 3e-2 + 1e-2 * r.abs() / scale).all()) and diff.mean().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tennis", "minecraft"])
def test_decoder_path_step_matches_the_cpu(card, name):
    """One phase-2 decoder-path step of the tiny tennis / Minecraft scene
    (chip_smoke.py 13a / 13c: 48x64, patch 8, strides (4, 8), the patch
    centre drawn once on the CPU) on the card against the CPU, with
    full-precision convolutions, at chip_smoke.py's TOLERANCES_13; the
    Minecraft overlap fix masks background samples on both."""
    sys_path_repo()
    import chip_smoke

    worst = chip_smoke.phase13_decoder_card_vs_cpu(str(REPO), name, devices=(card.type, "cpu"))
    assert worst["grads"] > 100
    assert name == "tennis" or worst["masked_background_samples"] > 0


@pytest.mark.cuda
def test_decoder_path_launches_the_fused_backbone_and_freezes_the_autoencoder(card):
    """Three steps of configs/tennis.yaml's phase 2 at full width and bs 1 x
    4 of 288x512 (chip_smoke.py 13b): 4 B2 and 4 B3 launches a step, the
    autoencoder frozen while the decoder's statistics move."""
    sys_path_repo()
    import chip_smoke

    result = chip_smoke.phase13_decoder_main_path(str(REPO), "tennis", batch_size=1, steps=3, device=card)
    assert result["launches"] == (12, 12) and all(np.isfinite(result["losses"]))


@pytest.mark.cuda
def test_phase1_step_matches_the_cpu(card):
    """One phase-1 step at the published widths (v8 and v9, f32 and bf16;
    chip_smoke.py 13d) on the card against the CPU, the posterior noise
    drawn once on the CPU, at chip_smoke.py's TOLERANCES_13 (a bf16 step
    also against the same step in f32)."""
    sys_path_repo()
    import chip_smoke

    results = chip_smoke.phase13_phase1_card_vs_cpu(devices=(card.type, "cpu"))
    assert set(results) == {"v8_float32", "v8_bfloat16", "v9_float32", "v9_bfloat16"}


@pytest.mark.cuda
def test_options_step_matches_the_cpu(card):
    """One decoder-path step of the tiny tennis scene with every option of
    phase 2 on (use_fine with separate fields, divergence, camera offsets
    at their own rate, remat; chip_smoke.py 14b) on the card against the
    CPU on the CPU's draws, with full-precision convolutions, at
    chip_smoke.py's TOLERANCES_14; then the card's step without remat
    against it."""
    sys_path_repo()
    import chip_smoke

    result = chip_smoke.phase14_options_card_vs_cpu(str(REPO), devices=(card.type, "cpu"))
    assert result["card_vs_cpu"]["grads"] > 100 and result["remat_vs_plain"]["grads"] > 100


@pytest.mark.cuda
def test_consistency_step_matches_the_cpu(card):
    """One decoder-path step of the tiny tennis scene with the pose,
    keypoint and keypoint-opacity weights on (chip_smoke.py 15b: a
    hand-made flow and COCO keypoints on the players) on the card against
    the CPU on the CPU's draws, with full-precision convolutions, at
    chip_smoke.py's TOLERANCES_15; every consistency metric above 0."""
    sys_path_repo()
    import chip_smoke

    result = chip_smoke.phase15_consistency_card_vs_cpu(str(REPO), devices=(card.type, "cpu"))
    assert result["grads"] > 100 and len(result["consistency_metrics"]) == 6


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["synthesis", "playable"])
def test_checkpoint_round_trip_on_the_card(card, phase, tmp_path):
    """A trainer's state saved from the card and restored onto the card into
    a trainer of another seed: every tensor on the card and bit for bit.
    Then the next step of both with deterministic algorithms
    (chip_smoke.deterministic_algorithms): the whole state again bit for
    bit."""
    sys_path_repo()
    import chip_smoke

    from playableenvironments_tpu_torch.cli.common import build_environment_model, synthesis_training_config
    from playableenvironments_tpu_torch.train import checkpointing
    from playableenvironments_tpu_torch.train.trainer_synthesis import SynthesisTrainer
    from playableenvironments_tpu_torch.utils.random import RngStreams

    if phase == "synthesis":
        cfg = chip_smoke.tiny_published_config(str(REPO), "tennis")
        train_cfg = chip_smoke.dataclasses.replace(synthesis_training_config(cfg), patch_size=chip_smoke.TINY_PATCH)
        batch = chip_smoke.decoder_batch(torch, "tennis", 2, 2, *chip_smoke.TINY_IMAGE, card)

        def make(seed):
            trainer = SynthesisTrainer(build_environment_model(cfg, device=card, seed=seed), train_cfg)
            return trainer, lambda rng_seed: trainer.train_step(batch, RngStreams(rng_seed, card))
    else:
        def make(seed):
            trainer, encoding = chip_smoke.phase3_trainer(card, seed=seed)
            return trainer, lambda rng_seed: trainer.fused_step(encoding, RngStreams(rng_seed, card))

    trainer, step = make(0)
    step(1)
    path = checkpointing.save_checkpoint(str(tmp_path), trainer)
    restored, restored_step = make(5)
    checkpointing.restore_checkpoint(path, restored)
    saved, got = checkpointing.flat_state(trainer), checkpointing.flat_state(restored)
    assert checkpointing.state_difference(got, saved) is None
    assert sum(torch.is_tensor(v) for v in saved.values()) > 100
    assert all(v.device.type == "cuda" for v in got.values() if torch.is_tensor(v) and v.dim() > 0)
    with chip_smoke.deterministic_algorithms():
        step(2)
        restored_step(2)
    difference = checkpointing.state_difference(checkpointing.flat_state(restored), checkpointing.flat_state(trainer))
    assert difference is None, difference


@pytest.mark.cuda
def test_rollout_single_launches_b4_alone_on_the_card(card):
    """The evaluators' whole-trajectory rollout (configs/tennis.yaml's
    animation model, bs 1 x 8 from one frame, a fixed action): one B4
    launch, no B5, no residuals; within 1e-4 of the plain rollout's largest
    magnitude (chip_smoke.py phase 8's bound)."""
    from playableenvironments_tpu_torch.ops import fused_rollout as fr
    from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel

    scene = scene_from_yaml(str(REPO / "configs" / "tennis.yaml"))
    playable = PlayableEnvironmentModel(scene, device=card, seed=3)
    anim = scene.animation_models[0]
    g = torch.Generator().manual_seed(4)
    state = [torch.randn(1, 1, w, generator=g).repeat(1, 8, 1).to(card)
             for w in (3, 3, anim.style_features, anim.deformation_features)]
    actions = torch.nn.functional.one_hot(torch.full((1, 7), 1), anim.actions_count).float().to(card)
    variations = torch.zeros(1, 7, anim.action_space_dimension, device=card)
    before = (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches)
    got = playable.rollout_single(1, *state, actions, variations)
    torch.cuda.synchronize()
    assert (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches) == (before[0] + 1, before[1])
    model = playable._animation_model(1)
    with torch.no_grad():
        ref = fr.plain_rollout_fwd(model.rollout_cfg, fr.pack_dynamics_params(model.dynamics_network), *state,
                                   actions, variations, 1, False)[0]
    for g_, r in zip(got, ref):
        assert g_.shape == (1, 8, r.shape[-1]) and g_.device.type == "cuda"
        assert (g_ - r).abs().max().item() <= 1e-4 * r.abs().max().item()


@pytest.mark.cuda
def test_phase1_cli_on_the_card(card, tmp_path, monkeypatch):
    """cli/train_autoencoder.py with --device cuda on
    configs/synthetic_smoke.yaml with a tiny autoencoder: 2 steps, a
    checkpoint whose tensors were saved from the card, its evaluator
    grid. (The Logger's wandb mirror is disabled: the run reaches no
    network.)"""
    import importlib
    import sys

    import yaml

    from playableenvironments_tpu_torch.data.synthetic import make_synthetic_dataset
    from playableenvironments_tpu_torch.train import checkpointing

    monkeypatch.setenv("WANDB_MODE", "disabled")
    make_synthetic_dataset(str(tmp_path / "data"), videos=1, frames=4, height=16, width=24)
    cfg = yaml.safe_load((REPO / "configs" / "synthetic_smoke.yaml").read_text())
    cfg["data"]["data_root"] = str(tmp_path / "data")
    cfg["logging"].update(output_root=str(tmp_path / "results"), checkpoints_root=str(tmp_path / "checkpoints"))
    cfg["model"]["autoencoder"] = {"input_features": 3, "bottleneck_features": 8, "bottleneck_blocks": 1,
                                   "downsampling_layers_count": [1, 1]}
    cfg["autoencoder_training"] = {"max_steps": 2, "batch_size": 2, "save_freq": 2, "eval_freq": 2,
                                   "log_interval_steps": 1}
    config = tmp_path / "smoke.yaml"
    config.write_text(yaml.safe_dump(cfg))
    argv, sys.argv = sys.argv, ["train_autoencoder", "--config", str(config), "--device", "cuda"]
    try:
        importlib.import_module("playableenvironments_tpu_torch.cli.train_autoencoder").main()
    finally:
        sys.argv = argv
    path = checkpointing.latest_checkpoint(str(tmp_path / "checkpoints" / "synthetic_smoke"))
    assert path.endswith("checkpoint_2")
    state = torch.load(pathlib.Path(path) / checkpointing.STATE_FILE, weights_only=True)
    assert all(v.device.type == "cuda" for v in state["model"].values())
    assert (tmp_path / "results" / "synthetic_smoke" / "images" / "00000002_autoencoder_reconstruction.png").exists()


@pytest.mark.cuda
def test_camera_manipulation_creator_b1_launch_matches_plain_on_the_card(card, tmp_path, monkeypatch):
    """The camera-manipulation creator on tennis at 48x64, one window of 3
    observations: one grouped B1 launch of 4 objects for the window (3x a
    frame's points), its objects against plain_adain_nerf on the launch's
    own inputs in units of each output's mean magnitude where that exceeds
    1 (chip_smoke.py's KERNEL_* bounds), and the window's frames all
    frame 0's (the split's camera stands still)."""
    from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
    from playableenvironments_tpu_torch.eval.creators import (
        FrameRenderer, ReconstructedCameraManipulationDatasetCreator,
    )

    sys_path_repo()
    import chip_smoke

    root = small_dataset(str(tmp_path / "data"), {"test": (1, 3)})
    scene = scene_from_yaml(str(REPO / "configs" / "tennis.yaml"))
    session = InteractiveSession.from_scene(scene, device=card, **SMALL)
    renderer = FrameRenderer(session.renderer.model, session.autoencoder, SMALL["image_size"], SMALL["patch_strides"])
    group, captured = fused_nerf.fused_adain_nerf_group, []

    def capture(cfg, items):
        outs = group(cfg, items)
        captured.append((cfg, items, outs))
        return outs

    monkeypatch.setattr(fused_nerf, "fused_adain_nerf_group", capture)
    before = (fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects)
    ReconstructedCameraManipulationDatasetCreator(renderer).reconstruct_dataset(
        MulticameraVideoDataset(f"{root}/test", observations_count=1), str(tmp_path / "mirror"), 3)
    assert (fused_nerf.fused_adain_nerf.launches, fused_nerf.fused_adain_nerf.objects) == (before[0] + 1, before[1] + 4)
    cfg, items, outs = captured[0]
    with torch.no_grad():
        for item, (feats, alpha) in zip(items, outs):
            refs = fused_nerf.plain_adain_nerf(cfg, item.weights.packed, item.encoded, item.scale0, item.bias0,
                                               item.scale1, item.bias1, item.samples_per_ray)
            for got, ref in ((feats, refs[0]), (alpha, refs[1])):
                scale = max(1.0, ref.abs().mean().item())
                diff = (got - ref).abs() / scale
                assert bool((diff <= chip_smoke.KERNEL_ATOL + chip_smoke.KERNEL_RTOL * ref.abs() / scale).all())
                assert diff.mean().item() <= chip_smoke.KERNEL_MEAN_ATOL
    mirror = MulticameraVideoDataset(str(tmp_path / "mirror"), observations_count=1)
    assert len(mirror) == 3
    for i in (1, 2):
        np.testing.assert_array_equal(mirror[i]["observations"], mirror[0]["observations"])


@pytest.mark.cuda
def test_evaluator_metrics_on_the_card_match_the_cpu(card, tmp_path):
    """ReconstructedDatasetEvaluator (masked-MSE windows of 2) on two
    synthetic trees of 2 videos x 4 frames at 32x48, its metric networks
    on the card against the same evaluator on the CPU: every result within
    chip_smoke.py's PHASE17_METRIC_RTOL, relative."""
    from playableenvironments_tpu_torch.data.synthetic import make_synthetic_dataset
    from playableenvironments_tpu_torch.eval.evaluators import ReconstructedDatasetEvaluator

    sys_path_repo()
    import chip_smoke

    roots = []
    for seed in (0, 1):
        roots.append(make_synthetic_dataset(str(tmp_path / f"tree{seed}"), videos=2, frames=4, seed=seed,
                                            splits=("test",)))
    results = [ReconstructedDatasetEvaluator(window_size=2, device=device).compute_metrics(
        f"{roots[0]}/test", f"{roots[1]}/test") for device in (card, "cpu")]
    assert set(results[0]) == set(results[1]) == set(chip_smoke.PHASE17_METRIC_RTOL) - {"fvd"}
    for key, value in results[1].items():
        assert abs(results[0][key] - value) <= chip_smoke.PHASE17_METRIC_RTOL[key] * abs(value), key
