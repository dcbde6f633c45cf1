"""The kernels' wrappers across the wide envelope the Pallas kernels take and
the port's wide kernels take (csrc/nerf_wgmma.cuh's column split, the f32
kernels' 256-column passes): widths to 512, encodings to 128 columns, 16
backbone layers, B1 to 512 outputs and a skip into layer 0.

- B1: the port's plain version against JAX's reference_adain_nerf at W 512,
  12 layers, pe 123, 320 outputs, 2 samples a ray, and against
  fused_adain_nerf in interpret mode at skip 0, both at
  test_torch_port_nerf.py's bf16 bound (5e-3: identical bf16 operand
  rounding, another f32 summation order); the weights are JAX's flax
  variables carried into the port's module by compat/from_flax.py.
- B2/B3 in bf16 and f32: the port's plain versions against JAX's
  fused_backbone and its VJP (the Pallas kernels in interpret mode) at W
  512, 16 layers, pe 123, at test_torch_port_backbone.py's bounds (f32
  1e-5, bf16 5e-3 of each output's largest magnitude), bf16 gradients in
  the mean, within the larger of 5e-3 of their largest magnitude and three
  times the port's own mean distance from its f64 sums: through 16 layers
  of bf16 cotangents two f32 summation orders of the same function part by
  up to 4e-2 of d_encoded's and w0's largest magnitude element-wise (the
  port's plain backward against itself with f64 sums, these inputs: a ReLU
  taken on the other side moves a point's whole term), as chip_smoke.py's
  SPREAD_FACTOR states for the card. The f32 case holds the same wiring
  element-wise at 1e-5.
- W 320 run padded to 512 against unpadded, at
  test_torch_port_narrow_widths.py's bound (1e-6 of each output's largest
  magnitude: the same products, the padded ones exactly 0), in f64: at 16
  layers the f32 sums' order, which differs between K 320 and 512, flips
  bf16 roundings, while f64 sums of the same bf16 products are exact on
  both sides, so the comparison holds the padding and not the order.
- Python copies of the wide kernels' index arithmetic read back against the
  packed weights: the column-split weight image (each warpgroup's half of a
  slot), the second encoding slot and B1's doubled layer 0 at skip 0, the
  backward's slot order, the ReLU-mask scratch, the dW product's column
  halves over the wide scratch, and the f32 images' passes and encoding
  groups with the row-block table.
- The refusals just above the envelope: W 576, pe 129, 17 layers, 513
  outputs, each a ValueError naming the limit.
- JAX's skip 0: its B1 and its module without the fused backbone concatenate
  the encoding into layer 0; its fused backbone declares and computes no
  skip there. Pinned on both sides; the port keeps each path's behaviour.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.config import NerfMLPConfig as JaxNerfMLPConfig
from playableenvironments_tpu.config import PositionalEncoderConfig as JaxPositionalEncoderConfig
from playableenvironments_tpu.models.nerf import AdaInNerfMLP as JaxAdaInNerfMLP
from playableenvironments_tpu.ops import fused_nerf as jax_fused
from playableenvironments_tpu_torch.compat.from_flax import load_flax_tree
from playableenvironments_tpu_torch.config import NerfMLPConfig, PositionalEncoderConfig
from playableenvironments_tpu_torch.models.nerf import AdaInNerfMLP
from playableenvironments_tpu_torch.ops import fused_nerf
from test_torch_port_backbone import relative_close, scratch_offset
from test_torch_port_backbone_f32 import slot_matrix
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
BF16_TOL = dict(atol=5e-3, rtol=5e-3)
EXACT = 1e-6  # of each output's largest magnitude
STYLE = 8


def configs(width, layers, skip, octaves, out=3, compute_dtype="bfloat16", fused=False):
    kw = dict(layers_width=width, backbone_layers_count=layers, skip_layer_idx=skip, output_features=out,
              compute_dtype=compute_dtype, use_fused_backbone=fused)
    return (JaxNerfMLPConfig(position_encoder=JaxPositionalEncoderConfig(octaves=octaves), **kw),
            NerfMLPConfig(position_encoder=PositionalEncoderConfig(octaves=octaves), **kw))


def flax_variables(jcfg, seed):
    """Seeded variables of JAX's AdaInNerfMLP in its own tree (shapes from
    jax.eval_shape of its init): kernels ~ N(0, 1 / fan_in), biases and
    AdaIN statistics small, variances positive."""
    module = JaxAdaInNerfMLP(jcfg, STYLE, ((-1.0, 1.0),) * 3)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((2, 3)), jnp.zeros((2, STYLE)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.normal(size=leaf.shape) * leaf.shape[0] ** -0.5).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.tree_util.tree_map(lambda x: x, shapes))


def port_nerf(cfg, variables):
    nerf = AdaInNerfMLP(cfg, STYLE, device="cpu")
    load_flax_tree(nerf, variables["params"], variables.get("batch_stats"))
    return nerf


def modulation(width, rays, rng):
    return [(rng.normal(size=(rays, c)) * 0.5).astype(np.float32) for c in (width, width, width // 2, width // 2)]


def near(got, ref, name):
    got, ref = got.detach().double(), ref.detach().double().reshape(got.shape)
    assert (got - ref).abs().max().item() <= EXACT * max(ref.abs().max().item(), 1e-30), name


# ---------------------------------------------------------------------------
# B1 against JAX
# ---------------------------------------------------------------------------


def test_plain_adain_mlp_matches_jax_reference_at_the_envelope():
    """W 512, 12 layers (skip 6), octaves 20 (pe 123), 320 outputs, 2
    samples a ray: the port's plain B1 on the module's packed weights
    against JAX's reference_adain_nerf on the same flax variables."""
    jcfg, cfg = configs(512, 12, 6, 20, out=320)
    variables = flax_variables(jcfg, seed=0)
    nerf = port_nerf(cfg, variables)
    rng = np.random.default_rng(1)
    rays, samples = 24, 2
    enc = rng.uniform(-1, 1, (rays * samples, 123)).astype(np.float32)
    mods = modulation(512, rays, rng)
    jpacked = jax_fused.pack_nerf_params(jcfg, variables["params"])
    ref = jax.jit(functools.partial(jax_fused.reference_adain_nerf, jcfg), compiler_options=FAST_COMPILE)(
        jpacked, jnp.asarray(enc), *(jnp.asarray(np.repeat(m, samples, axis=0)) for m in mods))
    packed = fused_nerf.pack_nerf_params(cfg, nerf)
    with torch.no_grad():
        got = fused_nerf.plain_adain_nerf(cfg, packed, torch.from_numpy(enc), *map(torch.from_numpy, mods), samples)
    assert got[0].shape == (rays * samples, 320)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **BF16_TOL)


def test_plain_adain_mlp_matches_jax_kernel_at_skip_0():
    """skip_layer_idx 0, where layer 0 reads [encoding, encoding] (w0 of 2
    pe rows, the module's without the fused backbone): JAX's Pallas kernel
    in interpret mode against the port's plain version, 384 points."""
    jcfg, cfg = configs(128, 3, 0, 4, out=8)
    variables = flax_variables(jcfg, seed=2)
    assert variables["params"]["backbone_0"]["kernel"].shape == (54, 128)
    nerf = port_nerf(cfg, variables)
    rng = np.random.default_rng(3)
    rays, samples = 192, 2
    enc = rng.uniform(-1, 1, (rays * samples, 27)).astype(np.float32)
    mods = modulation(128, rays, rng)
    ref = jax_fused.fused_adain_nerf(jcfg, jax_fused.pack_nerf_params(jcfg, variables["params"]), jnp.asarray(enc),
                                     *map(jnp.asarray, mods), samples_per_ray=samples, block_points=128,
                                     interpret=True)
    packed = fused_nerf.pack_nerf_params(cfg, nerf)
    assert fused_nerf.adain_encoding_width(cfg, packed) == 27
    with torch.no_grad():
        got = fused_nerf.plain_adain_nerf(cfg, packed, torch.from_numpy(enc), *map(torch.from_numpy, mods), samples)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **BF16_TOL)


# ---------------------------------------------------------------------------
# B2/B3 against JAX
# ---------------------------------------------------------------------------


def backbone_inputs(cfg, n, pe, seed=0):
    """Seeded weights drawn as test_torch_port_backbone.py draws them
    (kernels N(0, 1 / fan_in), flax's default scale), encodings and
    cotangents."""
    rng = np.random.default_rng(seed)
    packed = {}
    for i, w_in in enumerate(fused_nerf._backbone_sizes(cfg, pe)):
        packed[f"w{i}"] = (rng.normal(size=(w_in, cfg.layers_width)) * w_in ** -0.5).astype(np.float32)
        packed[f"b{i}"] = (rng.normal(size=(cfg.layers_width,)) * 0.1).astype(np.float32)
    packed["w_alpha"] = (rng.normal(size=(cfg.layers_width, 1)) * cfg.layers_width ** -0.5).astype(np.float32)
    packed["b_alpha"] = np.asarray([0.1], np.float32)
    encoded = rng.uniform(-1, 1, (n, pe)).astype(np.float32)
    g_h = rng.normal(size=(n, cfg.layers_width)).astype(np.float32)
    g_alpha = rng.normal(size=(n,)).astype(np.float32)
    return packed, encoded, g_h, g_alpha


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-3)])
def test_plain_backbone_and_its_backward_match_jax_at_the_envelope(compute_dtype, tol):
    """W 512, 16 layers (skip 8), pe 123: JAX's custom-VJP fused_backbone
    (forward and backward Pallas kernels in interpret mode, two blocks of 32
    points) against the port's plain forward and backward."""
    jcfg, cfg = configs(512, 16, 8, 20, compute_dtype=compute_dtype, fused=True)
    packed, encoded, g_h, g_alpha = backbone_inputs(cfg, 64, 123, seed=4)
    bf16 = compute_dtype == "bfloat16"

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def run(p, e, gh, ga):
        out, vjp = jax.vjp(lambda p, e: jax_fused.fused_backbone(jcfg, p, e, 32, True), p, e)
        return out, vjp((gh, ga))

    (jh, ja), (jd_packed, jd_encoded) = run({k: jnp.asarray(v) for k, v in packed.items()},
                                            *map(jnp.asarray, (encoded, g_h, g_alpha)))
    tpacked = {k: torch.from_numpy(v) for k, v in packed.items()}
    h, alpha = fused_nerf.plain_backbone_fwd(cfg, tpacked, torch.from_numpy(encoded))
    grads, d_encoded = fused_nerf.plain_backbone_bwd(cfg, tpacked, *map(torch.from_numpy, (encoded, g_h, g_alpha)))
    relative_close(h, jh, tol, "h")
    relative_close(alpha, ja, tol, "alpha")
    f64 = fused_nerf.plain_backbone_bwd(cfg, {k: v.double() for k, v in tpacked.items()},
                                        *(torch.from_numpy(x).double() for x in (encoded, g_h, g_alpha)))
    outputs = [("d_encoded", d_encoded, jd_encoded, f64[1])] + [
        (k, v.reshape(packed[k].shape), jd_packed[k], f64[0][k].reshape(packed[k].shape)) for k, v in grads.items()]
    for name, got, ref, own in outputs:
        ref = np.asarray(ref).reshape(got.shape)
        if not bf16:
            relative_close(got, ref, tol, name)
            continue
        mean = np.abs(got.numpy() - ref).mean()
        bound = max(tol * np.abs(ref).max(), 3 * (got.double() - own).abs().mean().item())
        assert mean <= bound, (name, mean, bound)


# ---------------------------------------------------------------------------
# W 320 run padded to 512
# ---------------------------------------------------------------------------


def test_adain_mlp_at_width_320_run_at_512_equals_the_unpadded_one():
    """16 layers, octaves 12 (pe 75): the weights and modulation zero-padded
    to the wide kernel's 512 give the 320-wide MLP's outputs (f64 sums)."""
    _, cfg = configs(320, 16, 8, 12, out=320)
    nerf = AdaInNerfMLP(cfg, STYLE, device="cpu")
    packed = fused_nerf.pack_nerf_params(cfg, nerf)
    assert fused_nerf.adain_kernel(cfg, packed) == (512, True)
    rng = np.random.default_rng(5)
    rays, samples = 16, 2
    packed = {k: v.detach().double() for k, v in packed.items()}
    encoded = torch.from_numpy(rng.uniform(-1, 1, (rays * samples, 75)))
    mods = [torch.from_numpy(m).double() for m in modulation(320, rays, rng)]
    kcfg, kpacked = fused_nerf.padded_weights(cfg, packed, 512)
    item = fused_nerf.padded_modulation(fused_nerf.AdaInNerfItem(None, encoded, *mods, samples), 512)
    with torch.no_grad():
        ref = fused_nerf.plain_adain_nerf(cfg, packed, encoded, *mods, samples)
        got = fused_nerf.plain_adain_nerf(kcfg, kpacked, encoded, *item[2:6], samples)
    for name, g, r in zip(("features", "alpha"), got, ref):
        near(g, r, name)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_backbone_at_width_320_run_at_512_equals_the_unpadded_one(compute_dtype):
    """The pad-run-cut code the card's wrappers run (padded_backbone_fwd/
    _bwd, the plain versions in place of the launches) at W 320 x 16 layers,
    pe 75: the outputs and the gradients cut back to the 320-wide shapes
    (f64 sums)."""
    _, cfg = configs(320, 16, 8, 12, compute_dtype=compute_dtype, fused=True)
    packed, encoded, g_h, g_alpha = (torch.from_numpy(np.asarray(x)).double() if not isinstance(x, dict) else
                                     {k: torch.from_numpy(v).double() for k, v in x.items()}
                                     for x in backbone_inputs(cfg, 40, 75, seed=6))
    assert fused_nerf.kernel_backbone(cfg, packed)[0].layers_width == 512
    for name, g, r in zip(("h", "alpha"),
                          fused_nerf.padded_backbone_fwd(cfg, packed, encoded, fused_nerf.plain_backbone_fwd),
                          fused_nerf.plain_backbone_fwd(cfg, packed, encoded)):
        assert g.shape == r.shape
        near(g, r, name)
    grads, d_encoded = fused_nerf.padded_backbone_bwd(cfg, packed, encoded, g_h, g_alpha,
                                                      fused_nerf.plain_backbone_bwd)
    ref_grads, ref_d_encoded = fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
    near(d_encoded, ref_d_encoded, "d_encoded")
    for name, ref in ref_grads.items():
        assert grads[name].shape == ref.shape, name
        near(grads[name], ref, name)


# ---------------------------------------------------------------------------
# The wide kernels' index arithmetic
# ---------------------------------------------------------------------------

# (width, layers, skip, pe): two encoding slots, one; the envelope's depth.
WIDE_LAYOUTS = [(512, 4, 2, 123), (256, 3, 1, 63), (256, 16, 8, 75)]


def slot_reader(width):
    """Element offsets of a 64-row slot's (row, column) in the bf16 image:
    W/64 swizzled 64 x 64 blocks, block c at c * 4096."""
    r, c = torch.meshgrid(torch.arange(64), torch.arange(width), indexing="ij")
    return (c // 64) * 64 * 64 + fused_nerf.swizzled(r, c % 64)


def wide_layer_slots(layers, nb, ps, skip):
    """nerf_wgmma.cuh::wide_layer_slots."""
    return [ps * (2 if skip == 0 else 1) if i == 0 else nb + (ps if i == skip else 0) for i in range(layers)]


def wide_forward(image, biases, width, layers, skip, ps, enc_tile):
    """The wide forward as csrc/fused_backbone.cu's backbone_wide_fwd_kernel
    (and B1's backbone) forms it: for each slot, warpgroup w's product of the
    tile's block (the encoding's block j % ps in layer 0, h's block j or the
    encoding's j - nb at the skip layer) with the slot's columns [w W/2,
    (w + 1) W/2), the two halves meeting in the tile."""
    nb, half, slot_elems = width // 64, width // 2, 64 * width
    read = slot_reader(width)
    w = image.float()
    act, s = None, 0
    for i, slots in enumerate(wide_layer_slots(layers, nb, ps, skip)):
        halves = []
        for wg in range(2):
            h = biases[i * width + wg * half: i * width + (wg + 1) * half].expand(enc_tile.shape[0], half).clone()
            for j in range(slots):
                if i == 0:
                    a = enc_tile[:, 64 * (j % ps): 64 * (j % ps) + 64]
                elif j < nb:
                    a = act[:, 64 * j: 64 * j + 64]
                else:
                    a = enc_tile[:, 64 * (j - nb): 64 * (j - nb) + 64]
                h += a @ w[(s + j) * slot_elems + read][:, wg * half:(wg + 1) * half]
            halves.append(h)
        s += slots
        act = torch.relu(torch.cat(halves, dim=1)).to(torch.bfloat16).float()
    return act, s


@pytest.mark.parametrize("width,layers,skip,pe", WIDE_LAYOUTS)
def test_wide_bf16_image_and_slot_order(width, layers, skip, pe):
    """The bf16 image of a wide configuration (the 128-point kernels' layout
    with ps = ceil(pe / 64) encoding slots) read as the wide kernels read it:
    each warpgroup's half of each slot, layer 0's and the skip layer's
    second encoding slot, gives the plain forward; the backward's slot
    order (the encoding's first, slot e to warpgroup e % 2; then h slot (m %
    2) W/128 + m / 2 to warpgroup m % 2) gives each warpgroup its own W/2
    columns of g @ W_i^T."""
    _, cfg = configs(width, layers, skip, 1, compute_dtype="bfloat16", fused=True)
    packed, encoded, g_h, _ = (torch.from_numpy(np.asarray(x)) if not isinstance(x, dict) else
                               {k: torch.from_numpy(v) for k, v in x.items()}
                               for x in backbone_inputs(cfg, 40, pe, seed=7))
    assert fused_nerf.backbone_is_wide(cfg, pe) == (pe > 64 or layers > 8)
    weights, biases = fused_nerf.backbone_buffers(cfg, packed)
    nb, ps = width // 64, -(-pe // 64)
    slots = wide_layer_slots(layers, nb, ps, skip)
    assert [len(s) for s in fused_nerf._layer_slots(cfg, pe)] == slots
    assert weights.numel() == sum(slots) * 64 * width + width
    enc_tile = torch.zeros(40, 64 * ps)
    enc_tile[:, :pe] = encoded.to(torch.bfloat16).float()
    h, used = wide_forward(weights, biases, width, layers, skip, ps, enc_tile)
    ref_h, _ = fused_nerf.plain_backbone_fwd(cfg, packed, encoded)
    torch.testing.assert_close(h, ref_h.to(torch.bfloat16).float(), rtol=2e-2, atol=2e-2)
    assert used == sum(slots)

    # The backward's products of the last layer, slot by slot in the
    # producer's order, each into its owner's accumulator.
    read, w = slot_reader(width), weights.float()
    i = layers - 1
    first = sum(slots[:i])
    g = g_h.to(torch.bfloat16).float()
    order = [(m % 2) * (nb // 2) + m // 2 for m in range(nb)]
    owned = {0: [], 1: []}
    for m, j in enumerate(order):
        owned[m % 2].append(g @ w[(first + j) * 64 * width + read].t())
    got = torch.cat([torch.cat(owned[0], dim=1), torch.cat(owned[1], dim=1)], dim=1)
    ref = g @ packed[f"w{i}"][:width].to(torch.bfloat16).float().t()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_adain_image_at_skip_0_doubles_layer_0():
    """B1 at skip 0 (wide kernel, W 256, pe 75 in 2 slots): layer 0's four
    slots hold w0's rows [0, pe) and [pe, 2 pe), each zero-padded to 128, and
    the wide forward over the image, reading the encoding tile in each,
    gives the plain forward of [encoding, encoding]; the head follows
    (W_f0, W_f1, W_out as whole slots)."""
    _, cfg = configs(256, 3, 0, 12, out=8)
    nerf = AdaInNerfMLP(cfg, STYLE, device="cpu")
    packed = fused_nerf.pack_nerf_params(cfg, nerf)
    assert packed["w0"].shape == (150, 256) and fused_nerf.adain_kernel(cfg, packed) == (256, True)
    image = fused_nerf.adain_image(cfg, packed)
    biases = torch.cat([packed[f"b{i}"] for i in range(3)] + [packed["b_alpha"]])
    read = slot_reader(256)
    for s in range(4):
        rows = packed["w0"][75 * (s // 2) + 64 * (s % 2): 75 * (s // 2) + min(64 * (s % 2) + 64, 75)]
        slot = image[s * 64 * 256 + read]
        assert torch.equal(slot[: rows.shape[0]], rows.to(torch.bfloat16)) and not slot[rows.shape[0]:].any()
    encoded = torch.rand(40, 75, generator=torch.Generator().manual_seed(8)) * 2 - 1
    enc_tile = torch.zeros(40, 128)
    enc_tile[:, :75] = encoded.to(torch.bfloat16).float()
    h, used = wide_forward(image, biases, 256, 3, 0, 2, enc_tile)
    ref = encoded.to(torch.bfloat16).float()
    ref = torch.cat([ref, ref], dim=1)
    for i in range(3):
        ref = torch.relu(ref @ packed[f"w{i}"].to(torch.bfloat16).float() + packed[f"b{i}"]).to(torch.bfloat16).float()
    torch.testing.assert_close(h, ref, rtol=2e-2, atol=2e-2)
    head = used * 64 * 256 + 256  # after w_alpha
    slots = [(packed["w_f0"], 4), (packed["w_f1"], 4), (torch.nn.functional.pad(packed["w_out"], (0, 56)), 2)]
    for mat, count in slots:
        cols = mat.shape[1]
        r, c = torch.meshgrid(torch.arange(64), torch.arange(cols), indexing="ij")
        at = (c // 64) * 4096 + fused_nerf.swizzled(r, c % 64)
        for k in range(count):
            assert torch.equal(image[head + k * 64 * cols + at], mat[64 * k: 64 * k + 64].to(torch.bfloat16))
        head += count * 64 * cols
    assert head == image.numel()


def test_mask_scratch_reads_back():
    """csrc/fused_backbone.cu's wide backward keeps each layer's ReLU bits
    in masks (grid, L, W/128, 256): thread ct's word w, bit b is its
    accumulator value v = 32 w + b (row 16 (t / 32) + (t % 32) / 4 + 8 (e /
    2), column wg W/2 + 8 j + 2 (t % 4) + e % 2 for v = 4 j + e): every
    (row, column) of the 64-point tile once, read back exactly."""
    width, layers, grid = 512, 3, 2
    half, words = width // 2, width // 128
    pattern = torch.rand(grid, layers, 64, width, generator=torch.Generator().manual_seed(9)) > 0.5
    shape = fused_nerf.backbone_wide_scratch_shapes(
        NerfMLPConfig(layers_width=width, backbone_layers_count=layers), 128, grid, 123)["masks"]
    assert shape == (grid, layers, words, 256)
    ct = torch.arange(256)
    wg, t = ct // 128, ct % 128
    v = torch.arange(half // 2)
    j, e = v // 4, v % 4
    row = (16 * (t // 32) + (t % 32) // 4)[:, None] + 8 * (e // 2)[None]
    col = (wg * half + 2 * (t % 4))[:, None] + (8 * j + e % 2)[None]
    covered = torch.zeros(64, width, dtype=torch.int64)
    covered.index_put_((row.reshape(-1), col.reshape(-1)), torch.ones(row.numel(), dtype=torch.int64), accumulate=True)
    assert bool((covered == 1).all())
    bits = pattern[:, :, row, col].reshape(grid, layers, 256, words, 32).long()
    scratch = (bits << torch.arange(32)).sum(-1).transpose(2, 3)  # (grid, L, words, 256)
    back = (scratch.transpose(2, 3)[..., None] >> torch.arange(32)) & 1
    unpacked = torch.zeros_like(pattern)
    unpacked[:, :, row, col] = back.reshape(grid, layers, 256, half // 2).bool()
    assert torch.equal(unpacked, pattern)


@pytest.mark.parametrize("width,layers,skip,pe", WIDE_LAYOUTS)
def test_wide_scratch_and_dw_halves(width, layers, skip, pe):
    """The wide backward's X and G scratch (64-point tiles, the encoding's
    ps blocks first in X) addressed as the kernels address them, and the dW
    product's tiles (backbone_x_columns, 64 padded rows a block) over its
    two column halves of W/2: X_in^T G of every layer in the padded row
    order."""
    cfg = NerfMLPConfig(layers_width=width, backbone_layers_count=layers, skip_layer_idx=skip)
    n, ps, nb = 150, -(-pe // 64), width // 64
    shapes = fused_nerf.backbone_wide_scratch_shapes(cfg, n, 132, pe)
    points = shapes["x"][0] * 64
    assert points >= n and shapes["tile_part"][0] == min(points // 64, 132) and shapes["x"][1] == ps + (layers - 1) * nb
    gen = torch.Generator().manual_seed(10)
    blocks, logical = {}, {}
    for name in ("x", "g"):
        columns = shapes[name][1]
        logical[name] = torch.randint(-4, 5, (points, columns * 64), generator=gen).float()
        p, f = torch.meshgrid(torch.arange(points), torch.arange(columns * 64), indexing="ij")
        off = scratch_offset(p, f // 64, f % 64, columns).reshape(-1)
        assert off.unique().numel() == off.numel() == math.prod(shapes[name])
        flat = torch.empty(off.numel())
        flat[off] = logical[name].reshape(-1)
        blocks[name] = flat.reshape(shapes[name])
    unswizzle = fused_nerf.swizzled(*torch.meshgrid(torch.arange(64), torch.arange(64), indexing="ij")).reshape(-1)

    def block(name, column):
        return blocks[name][:, column].reshape(-1, 4096)[:, unswizzle].reshape(points, 64)

    dw, start = torch.zeros(fused_nerf._backbone_grad_rows(cfg, pe), width), 0
    for layer, columns in enumerate(fused_nerf.backbone_x_columns(cfg, ps)):
        for z in range(2):  # the dW kernel's blockIdx.z: G's column blocks [z nb/2, (z + 1) nb/2)
            g = torch.cat([block("g", layer * nb + z * nb // 2 + j) for j in range(nb // 2)], dim=1)
            for b, column in enumerate(columns):
                dw[start + 64 * b: start + 64 * b + 64, z * width // 2:(z + 1) * width // 2] = block("x", column).t() @ g
        x = logical["x"]
        x_in = x[:, :64 * ps] if layer == 0 else x[:, 64 * (ps + (layer - 1) * nb): 64 * (ps + layer * nb)]
        if layer == skip:
            x_in = torch.cat([x_in, x[:, :64 * ps]], dim=1)
        ref = x_in.t() @ logical["g"][:, layer * width:(layer + 1) * width]
        assert torch.equal(dw[start: start + ref.shape[0]], ref), layer
        start += 64 * len(columns)
    assert start == dw.shape[0]


@pytest.mark.parametrize("width,layers,skip,pe", [(512, 3, 1, 123), (256, 3, 1, 123)])
def test_wide_f32_images_and_row_blocks(width, layers, skip, pe):
    """The f32 images of a wide configuration (plain_backbone_f32_buffers,
    the card's pack kernel's plain version) read as the tensor cores read
    B: forward slots in 256-column passes, each pass's k-steps of the
    layer's padded rows (pe padded to 128); backward slots in 64-row groups
    of the encoding rows, then 256-row groups of the activation rows, each
    over the output columns' k-steps; both the 3xTF32 halves of the padded
    weights. The row-block table reads the encoding's two X halves."""
    _, cfg = configs(width, layers, skip, 1, compute_dtype="float32", fused=True)
    packed = {k: torch.from_numpy(v) for k, v in backbone_inputs(cfg, 4, pe, seed=11)[0].items()}
    buffers = fused_nerf.plain_backbone_f32_buffers(cfg, packed)
    pe_pad = 128
    in_pad = [pe_pad if i == 0 else width + (pe_pad if i == skip else 0) for i in range(layers)]
    order = torch.tensor(tuple(2 * (k % 4) + k // 4 for k in range(8)))
    passes = width // 256
    for i, w in enumerate(fused_nerf.backbone_f32_weights(cfg, packed)):
        assert w.shape == (in_pad[i], width)
        big_ref, small_ref = fused_nerf.tf32_split(w)
        base = 2 * width * sum(in_pad[:i])
        for c in range(passes):
            for s in range(in_pad[i] // 8):
                big, small = slot_matrix(buffers.fwd, base + (c * in_pad[i] // 8 + s) * 16 * 256, 256)
                cols = slice(256 * c, 256 * c + 256)
                assert torch.equal(big, big_ref[8 * s + order, cols]) and torch.equal(small, small_ref[8 * s + order, cols])
        # bwd: n = the layer's input rows, k = its output columns.
        offset = base
        groups = ([(in_pad[i] - pe_pad + 64 * e, 64) for e in range(2)] if i in (0, skip) else [])
        groups += [(256 * c, 256) for c in range(passes)] if i > 0 else []
        for row0, rows in groups:
            for k in range(width // 8):
                big, small = slot_matrix(buffers.bwd, offset, rows)
                assert torch.equal(big, big_ref[row0: row0 + rows, 8 * k + order].t()), (i, row0, k)
                assert torch.equal(small, small_ref[row0: row0 + rows, 8 * k + order].t()), (i, row0, k)
                offset += 16 * rows
        assert offset == base + 2 * width * in_pad[i]
    table = fused_nerf.backbone_f32_row_blocks(cfg, pe)
    assert table[0] == (0, 0, 64, 0) and table[-1][1:] == (0, 64, skip) if skip == layers - 1 else True
    assert [t for t in table if t[3] == skip][-1][1:3] == (0, 64)


# ---------------------------------------------------------------------------
# Refusals just above the envelope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad,match", [(dict(width=704), "take widths up to 640"),
                                       (dict(pe=320), "exceeds the backbone kernels' 256"),
                                       (dict(width=256, layers=64), "runs on cuda or cpu tensors, not meta")])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_backbone_wrappers_refuse_shapes_above_the_envelope(bad, match, compute_dtype):
    """B2/B3's wrappers (meta tensors: the checks run before any launch)
    raise a ValueError naming the limit, forward and backward; a network of
    64 layers passes every shape check and is refused only for its meta
    device (depth is no limit of the kernels)."""
    shape = {**dict(width=512, pe=123, layers=16), **bad}
    _, cfg = configs(shape["width"], shape["layers"], 1, 1, compute_dtype=compute_dtype, fused=True)
    packed, encoded, g_h, g_alpha = backbone_inputs(cfg, 8, shape["pe"])
    meta = {k: torch.from_numpy(v).to("meta") for k, v in packed.items()}
    encoded, g_h, g_alpha = (torch.from_numpy(x).to("meta") for x in (encoded, g_h, g_alpha))
    with pytest.raises(ValueError, match=match):
        fused_nerf.fused_backbone_fwd(cfg, meta, encoded)
    with pytest.raises(ValueError, match=match):
        fused_nerf.fused_backbone_bwd(cfg, meta, encoded, g_h, g_alpha)


@pytest.mark.parametrize("bad,match", [(dict(width=704), "takes widths up to 640"),
                                       (dict(pe=320), "encoding width 320 exceeds the AdaIN-NeRF kernel's 256"),
                                       (dict(width=256, layers=64), None),
                                       (dict(out=1088), "output_features 1088 exceeds the AdaIN-NeRF kernel's 1024")])
def test_adain_image_refuses_shapes_above_the_envelope(bad, match):
    """B1's image raises a ValueError naming the limit at W 704, an encoding
    of 320 columns (w0's rows) and 1,088 outputs; a 64-layer network builds
    (depth is no limit of the kernels)."""
    shape = {**dict(width=512, layers=4, octaves=20, out=320), **bad}
    _, cfg = configs(shape["width"], shape["layers"], 1, shape["octaves"], out=shape["out"])
    packed = fused_nerf.pack_nerf_params(cfg, AdaInNerfMLP(cfg, STYLE, device="cpu"))
    if "pe" in shape:
        packed["w0"] = torch.zeros(shape["pe"], shape["width"])
    if match is None:
        image = fused_nerf.adain_image(cfg, packed)
        assert fused_nerf.adain_kernel(cfg, packed) == (256, True) and image.dtype == torch.bfloat16
        return
    with pytest.raises(ValueError, match=match):
        fused_nerf.adain_image(cfg, packed)


# ---------------------------------------------------------------------------
# JAX's skip 0
# ---------------------------------------------------------------------------


def test_jax_skip_0_differs_between_its_fused_backbone_and_its_module():
    """At skip_layer_idx 0, JAX's module without the fused backbone (and
    its B1) reads [encoding, encoding] in layer 0, a (2 pe, W) kernel; with
    use_fused_backbone it declares (pe, W) and its fused_backbone computes
    no skip (_backbone_sizes): two different functions of two different
    parameter trees. The port's module declares the same shapes on each
    path, and its plain B2 keeps the fused backbone's no-skip reading."""
    for fused, rows in ((False, 54), (True, 27)):
        jcfg, cfg = configs(32, 3, 0, 4, fused=fused)
        shapes = jax.eval_shape(JaxAdaInNerfMLP(jcfg, STYLE, ((-1.0, 1.0),) * 3).init, jax.random.PRNGKey(0),
                                jnp.zeros((2, 3)), jnp.zeros((2, STYLE)))
        assert shapes["params"]["backbone_0"]["kernel"].shape == (rows, 32)
        assert AdaInNerfMLP(cfg, STYLE, device="cpu").backbone_0.weight.shape == (32, rows)
    jcfg, cfg = configs(32, 3, 0, 4, compute_dtype="float32", fused=True)
    packed, encoded, _, _ = backbone_inputs(cfg, 64, 27, seed=12)
    assert packed["w0"].shape == (27, 32)
    jh, ja = jax_fused.fused_backbone(jcfg, {k: jnp.asarray(v) for k, v in packed.items()}, jnp.asarray(encoded),
                                      32, True)
    no_skip = dataclasses.replace(cfg, skip_layer_idx=3)  # a skip past the last layer: none
    h, alpha = fused_nerf.plain_backbone_fwd(no_skip, {k: torch.from_numpy(v) for k, v in packed.items()},
                                             torch.from_numpy(encoded))
    relative_close(h, jh, 1e-5, "h")
    relative_close(alpha, ja, 1e-5, "alpha")
