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
def test_kernel_rejects_host_modulation(card):
    cfg = NerfMLPConfig()
    nerf = AdaInNerfMLP(cfg, 64, device=card)
    mods = [torch.zeros(2, 256), torch.zeros(2, 256), torch.zeros(2, 128), torch.zeros(2, 128)]
    with pytest.raises(ValueError, match="must be on"):
        fused_nerf.fused_adain_nerf(cfg, nerf.kernel_weights(), torch.zeros(8, 63, device=card), *mods, samples_per_ray=4)


@pytest.mark.cuda
def test_session_on_the_card_launches_the_kernel_per_object(card):
    """Tennis at 48x64: 4 launches per frame, and the frames match the same
    seeded session on the CPU."""
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
    before = fused_nerf.fused_adain_nerf.launches
    frames = [(card_session.start(encoding), host_session.start(encoding))]
    frames.append((card_session.step([1, 2]), host_session.step([1, 2])))
    assert fused_nerf.fused_adain_nerf.launches == before + 8
    for got, ref in frames:
        np.testing.assert_allclose(got, ref, atol=1e-2)


BACKBONE = NerfMLPConfig(output_features=3, compute_dtype="bfloat16", use_fused_backbone=True,
                         position_encoder=PositionalEncoderConfig(octaves=10))


def backbone_inputs(card, points, seed=1):
    nerf = initialize_(AdaInNerfMLP(BACKBONE, 64, device=card), torch.Generator().manual_seed(0))
    packed = {k: v.detach().contiguous() for k, v in nerf.backbone_params().items()}
    g = torch.Generator().manual_seed(seed)
    encoded = positional_encoding(torch.rand(points, 3, generator=g) * 2 - 1, 10, True).to(card)
    g_h = (torch.randn(points, 256, generator=g) * 1e-3).to(card)
    g_alpha = (torch.randn(points, generator=g) * 1e-3).to(card)
    return packed, encoded, g_h, g_alpha


@pytest.mark.cuda
@pytest.mark.parametrize("points", [18432, 1000])
def test_backbone_kernels_match_plain_on_the_card(card, points):
    """Tennis widths (8x256, encoding 63): B2 and B3 against their plain
    versions on the same card, a ragged last tile included, B3
    bit-identical across launches, each launch counted once."""
    packed, encoded, g_h, g_alpha = backbone_inputs(card, points)
    before = (fused_nerf.fused_backbone_fwd.launches, fused_nerf.fused_backbone_bwd.launches)
    with torch.no_grad():
        got = fused_nerf.fused_backbone_fwd(BACKBONE, packed, encoded)
        grads, d_encoded = fused_nerf.fused_backbone_bwd(BACKBONE, packed, encoded, g_h, g_alpha)
        again, d_encoded_again = fused_nerf.fused_backbone_bwd(BACKBONE, packed, encoded, g_h, g_alpha)
        torch.cuda.synchronize()
        ref = fused_nerf.plain_backbone_fwd(BACKBONE, packed, encoded)
        ref_grads, ref_d_encoded = fused_nerf.plain_backbone_bwd(BACKBONE, packed, encoded, g_h, g_alpha)
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
def test_backbone_kernels_refuse_float32_operands(card):
    packed, encoded, g_h, g_alpha = backbone_inputs(card, 64)
    cfg = NerfMLPConfig(output_features=3, use_fused_backbone=True)
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        fused_nerf.fused_backbone_fwd(cfg, packed, encoded)
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        fused_nerf.fused_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)


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
