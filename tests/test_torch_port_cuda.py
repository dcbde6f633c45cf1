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
