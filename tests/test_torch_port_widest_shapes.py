"""The NeRF kernels' wrappers at the corners of the envelope the Pallas
kernels hold in a v6e's 32 MiB of VMEM (scripts/pallas_vmem_budget.py):
widths 576 and 640, encodings of 256 columns, any depth (32 and 64 layers),
B1 with 1,024 outputs.

- B1, B2 and B3 (bf16 and f32): the port's plain versions against the JAX
  package's XLA references at W 640 x 3 with a 4-block encoding, at W 256 x
  32 and (B1) with 1,024 outputs: B1 against reference_adain_nerf; B2/B3
  against JAX's AdaInNerfMLP without the fused backbone (its Dense layers
  through XLA), fed the same encodings (its positional encoding replaced by
  the identity for the test), h from its last backbone layer, the f32
  gradients by jax.vjp; the bf16 gradients against JAX's fused_backbone
  VJP, its Pallas kernels in interpret mode over one block of 48 points.
  Bounds in each docstring.
- The Pallas kernels in interpret mode at one small wide shape, W 576
  (which the port runs zero-padded to 640) over 64 points: B1 and the
  backbone's custom VJP in both compute dtypes.
- Python copies of the index arithmetic the wide kernels gained: the ring's
  half-slots gathered from the unchanged images (nerf_wgmma.cuh::
  produce_half) and read as wgmma's B, the 320 columns a warpgroup takes at
  W 640 as m64n192 and m64n128 (wgmma_columns), the backward's half-slot
  order (half_order), the 4-block encoding, B1's f1 split and output passes,
  the f32 kernels' 128-column passes at W 640 and their stash, the f32 pack
  kernel's launches of 16 layers; each read weight for weight against the
  images, and the shared-memory sums at the envelope's corners (they do
  not depend on depth or outputs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.models import nerf as jnerf
from playableenvironments_tpu.ops import fused_nerf as jax_fused
from playableenvironments_tpu_torch.config import NerfMLPConfig
from playableenvironments_tpu_torch.ops import fused_nerf
from test_torch_port_backbone import relative_close
from test_torch_port_backbone_f32 import slot_matrix
from test_torch_port_wide_shapes import (BF16_TOL, FAST_COMPILE, STYLE, backbone_inputs, configs, flax_variables,
                                         modulation, port_nerf)
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

MAX_SMEM = 232448  # bytes of shared memory one CTA may take on an H100
# The port's plain bf16 B2/B3 against the Pallas kernels in interpret mode,
# in the mean, of each output's largest magnitude: both round the same
# operands to bf16 and sum in f32, and part only where their summation
# orders round a value to the other bf16 neighbour (1.2e-5 at most at this
# file's shapes). A backward that leaves the operands of g @ W^T unrounded
# reads 2e-3, of X^T g 3.5e-4; one without the skip gradient 3e-3.
PALLAS_BF16_MEAN = 1e-4


# ---------------------------------------------------------------------------
# B1 against reference_adain_nerf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width,layers,skip,octaves,out", [(640, 3, 1, 42, 3), (256, 32, 16, 10, 3),
                                                           (512, 3, 1, 10, 1024)],
                         ids=["640x3-pe255", "256x32", "1024-outputs"])
def test_plain_adain_mlp_matches_jax_reference(width, layers, skip, octaves, out):
    """The port's plain B1 on the module's packed weights against JAX's
    reference_adain_nerf (f32 XLA) on the same flax variables, 16 rays of 2
    samples, at test_torch_port_wide_shapes.py's bf16 bound (5e-3 relative
    and absolute: the port rounds every product's operands to bf16 as the
    Pallas kernel does, the reference does not). Octaves 42 give 255
    encoding columns, four 64-column blocks."""
    jcfg, cfg = configs(width, layers, skip, octaves, out=out)
    variables = flax_variables(jcfg, seed=width + layers)
    nerf = port_nerf(cfg, variables)
    pe = 6 * octaves + 3
    rng = np.random.default_rng(layers)
    rays, samples = 16, 2
    enc = rng.uniform(-1, 1, (rays * samples, pe)).astype(np.float32)
    mods = modulation(width, rays, rng)
    ref = jax.jit(functools.partial(jax_fused.reference_adain_nerf, jcfg), compiler_options=FAST_COMPILE)(
        jax_fused.pack_nerf_params(jcfg, variables["params"]), jnp.asarray(enc),
        *(jnp.asarray(np.repeat(m, samples, axis=0)) for m in mods))
    packed = fused_nerf.pack_nerf_params(cfg, nerf)
    assert fused_nerf.adain_kernel(cfg, packed)[0] == width
    with torch.no_grad():
        got = fused_nerf.plain_adain_nerf(cfg, packed, torch.from_numpy(enc), *map(torch.from_numpy, mods), samples)
    assert got[0].shape == (rays * samples, out)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **BF16_TOL)


# ---------------------------------------------------------------------------
# B2/B3 against JAX's module without the fused backbone
# ---------------------------------------------------------------------------


def module_backbone(jcfg, pe, seed, monkeypatch):
    """JAX's AdaInNerfMLP without the fused backbone, reading its input as
    the encoding itself (its positional encoding and box scaling replaced
    for the test), and seeded variables on its tree: (module, variables)."""
    monkeypatch.setattr(jnerf, "positional_encoding", lambda x, octaves, append_original: x)
    monkeypatch.setattr(jnerf, "aabb_size", lambda box: jnp.ones((), box.dtype))
    module = jnerf.AdaInNerfMLP(jcfg, STYLE, ((-1.0, 1.0),) * 3)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((2, pe)), jnp.zeros((2, STYLE)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.normal(size=leaf.shape) * leaf.shape[0] ** -0.5).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)

    return module, jax.tree_util.tree_map_with_path(fill, shapes)


def module_run(jcfg, module, variables, layers, style, enc, cotangents=None):
    """JAX's module (module_backbone) over `enc`: (h, alpha), h its last
    backbone layer's output after the ReLU; with `cotangents` (g_h,
    g_alpha) also the backbone's gradients and d_encoded by jax.vjp."""
    names = [f"backbone_{i}" for i in range(layers)] + ["alpha_head"]
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def run(params, e, cots):
        def backbone(p, e):
            (_, alpha), state = module.apply({"params": {**params, **p}, "batch_stats": variables["batch_stats"]},
                                             e, jnp.asarray(style), use_running_average=True,
                                             capture_intermediates=True, mutable=["intermediates"])
            h = jax.nn.relu(state["intermediates"][f"backbone_{layers - 1}"]["__call__"][0])
            return h.astype(jnp.float32), alpha.astype(jnp.float32)

        if cots is None:
            return backbone({k: params[k] for k in names}, e)
        out, vjp = jax.vjp(backbone, {k: params[k] for k in names}, e)
        return out, vjp(cots)

    return run(params, jnp.asarray(enc), None if cotangents is None else tuple(map(jnp.asarray, cotangents)))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width,layers,skip,pe", [(640, 3, 1, 256), (256, 32, 16, 63)], ids=["640x3-pe256", "256x32"])
def test_plain_backbone_and_its_backward_match_the_jax_module(width, layers, skip, pe, compute_dtype, monkeypatch):
    """The port's plain B2 and B3 against the JAX package over the same 48
    encodings: h (the last backbone layer's output after the ReLU), alpha,
    the backbone's gradients and d_encoded from the same cotangents.

    f32: against JAX's module without the fused backbone (its Dense layers
    through XLA, the gradients by jax.vjp), every output within 1e-5 of its
    largest magnitude (test_torch_port_backbone.py's bound; two f32
    summation orders).

    bf16: the forward against the module in bf16, in the mean within 2^-7
    of each output's largest magnitude: the module rounds each Dense output
    to bf16 and adds its bias in bf16, the port (as the Pallas kernels) sums
    and adds in f32 and rounds only the next product's operands, an output's
    rounding 2^-9 of itself, a few of them in the mean. Neither the module's
    bf16 backward (it rounds every cotangent and sums the bias gradients in
    bf16: b_alpha's, a sum of 48 cotangents, reads 6-10% from the f32 one)
    nor its f32 one (the bf16 forward's ReLUs fall on the other side of
    f32's in a few units a layer, each moving a whole cotangent) is the
    kernels' backward, so the bf16 gradients (and h and alpha once more)
    are held against the JAX package's fused_backbone and its VJP, its
    Pallas kernels in interpret mode (one block of 48 points), in the mean
    within PALLAS_BF16_MEAN of their largest magnitude."""
    jcfg, cfg = configs(width, layers, skip, 1, compute_dtype=compute_dtype)
    module, variables = module_backbone(jcfg, pe, seed=width + layers, monkeypatch=monkeypatch)
    rng = np.random.default_rng(layers)
    n = 48
    enc = rng.uniform(-1, 1, (n, pe)).astype(np.float32)
    style = rng.normal(size=(n, STYLE)).astype(np.float32)
    g_h = rng.normal(size=(n, width)).astype(np.float32)
    g_alpha = rng.normal(size=(n,)).astype(np.float32)
    bf16 = compute_dtype == "bfloat16"
    packed = {}
    for i in range(layers):
        packed[f"w{i}"] = torch.from_numpy(np.asarray(variables["params"][f"backbone_{i}"]["kernel"]))
        packed[f"b{i}"] = torch.from_numpy(np.asarray(variables["params"][f"backbone_{i}"]["bias"]))
    packed["w_alpha"] = torch.from_numpy(np.asarray(variables["params"]["alpha_head"]["kernel"]))
    packed["b_alpha"] = torch.from_numpy(np.asarray(variables["params"]["alpha_head"]["bias"]))
    if bf16:
        jh, jalpha = module_run(jcfg, module, variables, layers, style, enc)

        @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
        def pallas_vjp(p, e, gh, ga):
            out, vjp = jax.vjp(lambda p, e: jax_fused.fused_backbone(jcfg, p, e, n, True), p, e)
            return out, vjp((gh, ga))

        pallas_out, (jgrads, jd_enc) = pallas_vjp({k: jnp.asarray(v.numpy()) for k, v in packed.items()},
                                                  *map(jnp.asarray, (enc, g_h, g_alpha)))
    else:
        (jh, jalpha), (module_grads, jd_enc) = module_run(jcfg, module, variables, layers, style, enc,
                                                          (g_h, g_alpha))
        jgrads = {"w_alpha": module_grads["alpha_head"]["kernel"], "b_alpha": module_grads["alpha_head"]["bias"]}
        for i in range(layers):
            jgrads[f"w{i}"] = module_grads[f"backbone_{i}"]["kernel"]
            jgrads[f"b{i}"] = module_grads[f"backbone_{i}"]["bias"]
    inputs = tuple(map(torch.from_numpy, (enc, g_h, g_alpha)))
    h, alpha = fused_nerf.plain_backbone_fwd(cfg, packed, inputs[0])
    grads, d_enc = fused_nerf.plain_backbone_bwd(cfg, packed, *inputs)
    for name, got, ref in (("h", h, jh), ("alpha", alpha, jalpha)):
        ref = np.asarray(ref).reshape(got.shape)
        if bf16:
            assert np.abs(got.numpy() - ref).mean() <= 2.0 ** -7 * np.abs(ref).max(), name
        else:
            relative_close(got.numpy(), ref, 1e-5, name)
    outputs = [("d_encoded", d_enc, jd_enc)] + [(k, grads[k], jgrads[k]) for k in grads]
    assert len(outputs) == 2 * layers + 3
    if bf16:
        outputs += [("h (Pallas)", h, pallas_out[0]), ("alpha (Pallas)", alpha, pallas_out[1])]
    for name, got, ref in outputs:
        ref = np.asarray(ref).reshape(got.shape)
        if bf16:
            mean = np.abs(got.numpy() - ref).mean()
            assert mean <= PALLAS_BF16_MEAN * np.abs(ref).max(), (name, mean)
        else:
            relative_close(got.numpy(), ref, 1e-5, name)


# ---------------------------------------------------------------------------
# The Pallas kernels in interpret mode at W 576
# ---------------------------------------------------------------------------


def test_plain_adain_mlp_matches_the_pallas_kernel_at_width_576():
    """JAX's B1 Pallas kernel in interpret mode (one block of 64 points, 2
    samples a ray) at W 576 x 2, octaves 4, 8 outputs, against the port's
    plain version at the bf16 bound (5e-3), and the port's plain version
    at 576 against the same MLP zero-padded to 640, the width its kernel
    runs it at, within 1e-6 of each output's largest magnitude in f64 sums
    (test_torch_port_wide_shapes.py's bound for the padding)."""
    jcfg, cfg = configs(576, 2, 1, 4, out=8)
    variables = flax_variables(jcfg, seed=5)
    nerf = port_nerf(cfg, variables)
    rng = np.random.default_rng(6)
    rays, samples = 32, 2
    enc = rng.uniform(-1, 1, (rays * samples, 27)).astype(np.float32)
    mods = modulation(576, rays, rng)
    ref = jax_fused.fused_adain_nerf(jcfg, jax_fused.pack_nerf_params(jcfg, variables["params"]), jnp.asarray(enc),
                                     *map(jnp.asarray, mods), samples_per_ray=samples, block_points=64, interpret=True)
    packed = fused_nerf.pack_nerf_params(cfg, nerf)
    assert fused_nerf.adain_kernel(cfg, packed) == (640, True)
    with torch.no_grad():
        got = fused_nerf.plain_adain_nerf(cfg, packed, torch.from_numpy(enc), *map(torch.from_numpy, mods), samples)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **BF16_TOL)
    p64 = {k: v.detach().double() for k, v in packed.items()}
    m64 = [torch.from_numpy(m).double() for m in mods]
    e64 = torch.from_numpy(enc).double()
    kcfg, kpacked = fused_nerf.padded_weights(cfg, p64, 640)
    item = fused_nerf.padded_modulation(fused_nerf.AdaInNerfItem(None, e64, *m64, samples), 640)
    with torch.no_grad():
        unpadded = fused_nerf.plain_adain_nerf(cfg, p64, e64, *m64, samples)
        padded = fused_nerf.plain_adain_nerf(kcfg, kpacked, e64, *item[2:6], samples)
    for g, r in zip(padded, unpadded):
        assert (g - r).abs().max().item() <= 1e-6 * r.abs().max().item()


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-3)])
def test_plain_backbone_matches_the_pallas_kernels_at_width_576(compute_dtype, tol):
    """JAX's custom-VJP fused_backbone (forward and backward Pallas kernels
    in interpret mode, two blocks of 32 points) at W 576 x 3, pe 75,
    against the port's plain forward and backward at
    test_torch_port_backbone.py's bounds (f32 1e-5, bf16 5e-3 of each
    output's largest magnitude)."""
    jcfg, cfg = configs(576, 3, 1, 12, compute_dtype=compute_dtype, fused=True)
    packed, encoded, g_h, g_alpha = backbone_inputs(cfg, 64, 75, seed=13)
    assert fused_nerf.backbone_kernel_width(cfg, 75) == 640

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
    relative_close(d_encoded, jd_encoded, tol, "d_encoded")
    for k, v in grads.items():
        relative_close(v.reshape(packed[k].shape), jd_packed[k], tol, k)


# ---------------------------------------------------------------------------
# The wide bf16 kernels' half-slots (csrc/nerf_wgmma.cuh)
# ---------------------------------------------------------------------------

HALF = 32 * 64  # bf16 elements of a half (32 rows) of a swizzled 64 x 64 block


def wide_stages(width):
    """nerf_wgmma.cuh::wide_stages: what the activation tile leaves of 160
    KB, in slots of 64 W bytes, at most 8."""
    return min(8, (160 * 1024 - 128 * width) // (64 * width))


def produce_half(image, first, blocks, half):
    """nerf_wgmma.cuh::produce_half: half `half` of `blocks` swizzled 64 x
    64 blocks from element `first` (4,096 apart), as the ring holds it (the
    half-blocks 2,048 elements apart)."""
    return torch.cat([image[first + b * 4096 + half * HALF: first + b * 4096 + (half + 1) * HALF]
                      for b in range(blocks)])


def read_half(ring_slot, cols):
    """A ring half-slot read as wgmma's MN-major B: (32 K rows, cols) with
    column c in half-block c // 64 at the 128-byte swizzle of its row."""
    r, c = torch.meshgrid(torch.arange(32), torch.arange(cols), indexing="ij")
    return ring_slot[(c // 64) * HALF + fused_nerf.swizzled(r, c % 64)]


def wgmma_columns(n, b0):
    """nerf_wgmma.cuh::wgmma_columns: the products of a warpgroup's n
    columns from half-block b0, as (columns, first half-block, accumulator
    offset): one up to 256 columns, else m64n192 then m64n128 at acc + 96."""
    first = n if n <= 256 else 192
    return [(first, b0, 0)] + ([(n - first, b0 + first // 64, first // 2)] if n > first else [])


def accumulator_columns(n):
    """Column of accumulator register v of thread t of an m64nNk16 product
    (nerf_wgmma.cuh's fragment layout): 8 (v // 4) + 2 (t % 4) + v % 2."""
    t, v = torch.meshgrid(torch.arange(128), torch.arange(n // 2), indexing="ij")
    return 8 * (v // 4) + 2 * (t % 4) + v % 2


def half_order(s):
    """nerf_wgmma.cuh::half_order."""
    return 2 * (s >> 2) + (s & 1), (s >> 1) & 1


def wide_layer_slots(layers, nb, ps, skip):
    return [ps * (2 if skip == 0 else 1) if i == 0 else nb + (ps if i == skip else 0) for i in range(layers)]


@pytest.mark.parametrize("width,layers,skip,pe", [(640, 3, 1, 256), (512, 3, 2, 200), (256, 4, 2, 63)])
def test_half_slots_give_the_forward_and_the_backward(width, layers, skip, pe):
    """The bf16 image of backbone_buffers (unchanged) streamed as the wide
    kernels stream it, each 64-row weight slot as two half-slots gathered
    block by block, read as wgmma's B: warpgroup w's W/2 columns (at W 640
    m64n192 + m64n128 from half-block 5 w, into one accumulator laid out as
    m64n320's) over every layer's half-slots give the plain forward, the
    encoding in ps = ceil(pe / 64) blocks (4 at 256 columns); the
    backward's half-slots of the last layer, in half_order (owner slot % 2,
    32 columns each into acc + 32 (slot / 2) + 16 half), give each
    warpgroup its own W/2 columns of g @ W^T."""
    _, cfg = configs(width, layers, skip, 1, compute_dtype="bfloat16", fused=True)
    packed, encoded, g_h, _ = ({k: torch.from_numpy(v) for k, v in x.items()} if isinstance(x, dict) else
                               torch.from_numpy(np.asarray(x)) for x in backbone_inputs(cfg, 40, pe, seed=14))
    weights, biases = fused_nerf.backbone_buffers(cfg, packed)
    nb, ps, half = width // 64, -(-pe // 64), width // 2
    assert fused_nerf._encoding_blocks(pe) == ps
    slots = wide_layer_slots(layers, nb, ps, skip)
    w = weights.float()
    # The accumulator of a warpgroup's W/2 columns: the products' columns tile it once, in m64nW/2 order.
    parts = wgmma_columns(half, 0)
    assert sum(n for n, _, _ in parts) == half and all(n % 64 == 0 and n <= 256 for n, _, _ in parts)
    layout = accumulator_columns(half)
    for n, b0, offset in parts:
        assert torch.equal(accumulator_columns(n) + 64 * b0, layout[:, offset: offset + n // 2])
    enc_tile = torch.zeros(40, 64 * ps)
    enc_tile[:, :pe] = encoded.to(torch.bfloat16).float()
    act, s = None, 0
    for i, count in enumerate(slots):
        out = biases[i * width: (i + 1) * width].expand(40, width).clone()
        for j in range(count):
            if i == 0:
                a = enc_tile[:, 64 * (j % ps): 64 * (j % ps) + 64]
            else:
                a = act[:, 64 * j: 64 * j + 64] if j < nb else enc_tile[:, 64 * (j - nb): 64 * (j - nb) + 64]
            for h in range(2):
                b = read_half(produce_half(w, (s + j) * 64 * width, nb, h), width)
                for wg in range(2):
                    for n, b0, _ in wgmma_columns(half, wg * nb // 2):
                        cols = slice(64 * b0, 64 * b0 + n)
                        out[:, cols] += a[:, 32 * h: 32 * h + 32] @ b[:, cols]
        s += count
        act = torch.relu(out).to(torch.bfloat16).float()
    assert s * 64 * width + width == weights.numel()
    ref, _ = fused_nerf.plain_backbone_fwd(cfg, packed, encoded)
    torch.testing.assert_close(act, ref.to(torch.bfloat16).float(), rtol=2e-2, atol=2e-2)

    i, g = layers - 1, g_h.to(torch.bfloat16).float()
    first = sum(slots[:i])
    order = [half_order(s) for s in range(2 * nb)]
    acc = torch.zeros(2, 40, half)
    for slot, h in order:
        j = first + (slot % 2) * (nb // 2) + slot // 2
        b = read_half(produce_half(w, j * 64 * width, nb, h), width)  # (32 rows of the slot, W columns)
        offset = 32 * (slot // 2) + 16 * h  # of acc, two columns a register
        acc[slot % 2][:, 2 * offset: 2 * offset + 32] = g @ b.t()
    ref = g @ packed[f"w{i}"][:width].to(torch.bfloat16).float().t()
    torch.testing.assert_close(torch.cat([acc[0], acc[1]], dim=1), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nb", [4, 8, 10])
def test_half_order_alternates_owners(nb):
    """half_order over a layer's nb h slots (W/64: 4, 8, 10) covers each
    (slot, half) once and hands consecutive half-slots to the two
    warpgroups (owner slot % 2) by turns."""
    order = [half_order(s) for s in range(2 * nb)]
    assert sorted(order) == [(m, h) for m in range(nb) for h in range(2)]
    assert all(order[k][0] % 2 != order[k + 1][0] % 2 for k in range(len(order) - 1))


@pytest.mark.parametrize("width,out", [(640, 1024), (512, 1000), (256, 96), (640, 3)])
def test_adain_head_split_and_output_passes(width, out):
    """B1's wide head (fused_nerf.cu::adain_wide_kernel): f1's W/2 columns
    split F1A = 64 ceil(W / 256) and the rest (whole 64-column blocks: 192
    and 128 at W 640), and the outputs in passes of OP = min(W, 512)
    columns, warpgroup w taking the pass's blocks 2 m + w: every output
    column once; each pass's half-slots, gathered from W_out's 64-row slots
    (adain_image, unchanged) block by block, read back W_out."""
    nb = width // 64
    f1a = 64 * -(-nb // 4)
    assert f1a % 64 == 0 and (width // 2 - f1a) % 64 == 0 and 0 < width // 2 - f1a <= f1a <= 256
    op = min(width, 512)
    opb, no = op // 64, -(-out // 64) * 64
    chunks = no // 64
    passes = -(-chunks // opb)
    covered = torch.zeros(no, dtype=torch.int64)
    w_out = torch.randn(width // 2, no, generator=torch.Generator().manual_seed(15))
    image = torch.cat([fused_nerf._swizzled_blocks(w_out[64 * k: 64 * k + 64])[:, fused_nerf._unswizzle("cpu")]
                       .reshape(-1) for k in range(nb // 2)])
    for o in range(passes):
        blocks = min(opb, chunks - o * opb)
        assert 32 * blocks * 64 * 2 <= 64 * width  # a pass's half-slot fits the ring's slot
        for m in range(opb // 2):
            for wg in range(2):
                if 2 * m + wg < blocks:
                    covered[64 * (o * opb + 2 * m + wg): 64 * (o * opb + 2 * m + wg) + 64] += 1
        for k in range(nb // 2):
            for h in range(2):
                got = read_half(produce_half(image, k * 64 * no + o * opb * 4096, blocks, h), 64 * blocks)
                ref = w_out[64 * k + 32 * h: 64 * k + 32 * h + 32, 64 * o * opb: 64 * (o * opb + blocks)]
                assert torch.equal(got, ref), (o, k, h)
    assert bool((covered == 1).all())


def test_shared_memory_fits_at_the_envelope_corners():
    """The wide kernels' shared memory (Python copies of wide_smem in
    fused_backbone.cu, fused_nerf.cu and fused_backbone_f32.cu) at W 256,
    512 and 640 with the 4-block encoding tile fits the 227 KB a CTA may
    have, with at least two ring stages; none depends on depth or on B1's
    outputs (the masks, X/G and the f32 stash are global scratch sized by
    the wrapper, the output passes reuse the ring's slots)."""
    enc, staging = 4 * 64 * 128, 8 * 256 * 4
    for width in (256, 512, 640):
        stages, slot = wide_stages(width), 64 * width
        assert stages >= 2 and stages * slot + 128 * width <= 160 * 1024
        b2b3 = 1024 + stages * slot + 128 * width + enc + staging + 256
        b1 = 1024 + stages * slot + 128 * width + enc + 256 + 256
        np_ = fused_nerf.backbone_f32_pass(width)
        f32 = 1024 + 4 * 64 * np_ + (width // 8) * 2048 + 4 * 64 + 2 * 4 * 256 * 4 + 16 * 4
        assert max(b2b3, b1, f32) <= MAX_SMEM, (width, b2b3, b1, f32)
    assert (wide_stages(256), wide_stages(512), wide_stages(640)) == (8, 3, 2)
    for layers in (8, 64):
        cfg = NerfMLPConfig(layers_width=640, backbone_layers_count=layers, skip_layer_idx=layers // 2)
        shapes = fused_nerf.backbone_wide_scratch_shapes(cfg, 1000, 132, 256)
        assert shapes["masks"] == (16, layers, 5, 256) and shapes["x"][1] == 4 + (layers - 1) * 10
        f32 = fused_nerf.backbone_f32_scratch_shapes(NerfMLPConfig(layers_width=640, backbone_layers_count=layers,
                                                                   skip_layer_idx=layers // 2), 1000, 132, 256)
        assert f32["masks"] == (16, layers, 5, 256) and f32["stash"] == (16, 80 + 32, 128, 4)
    assert fused_nerf.backbone_wide_dw_columns(640) == 128 and fused_nerf.backbone_wide_dw_columns(512) == 256


# ---------------------------------------------------------------------------
# The f32 kernels at W 640 (csrc/fused_backbone_f32.cu)
# ---------------------------------------------------------------------------


def test_f32_images_at_width_640_take_128_column_passes():
    """plain_backbone_f32_buffers at W 640 x 3 (skip 1), pe 256 (the card's
    pack kernel's plain version) read as the tensor cores read B: forward
    slots in five 128-column passes, each pass's k-steps of the layer's
    padded rows; backward slots in 64-row groups of the encoding rows (four
    at 256 columns), then 128-row groups of the activation rows, each over
    the output columns' k-steps; both 3xTF32 halves of the padded weights."""
    width, layers, skip, pe = 640, 3, 1, 256
    _, cfg = configs(width, layers, skip, 1, compute_dtype="float32", fused=True)
    packed = {k: torch.from_numpy(v) for k, v in backbone_inputs(cfg, 4, pe, seed=16)[0].items()}
    buffers = fused_nerf.plain_backbone_f32_buffers(cfg, packed)
    np_, pe_pad = fused_nerf.backbone_f32_pass(width), 256
    assert np_ == 128
    in_pad = [pe_pad if i == 0 else width + (pe_pad if i == skip else 0) for i in range(layers)]
    order = torch.tensor(tuple(2 * (k % 4) + k // 4 for k in range(8)))
    for i, w in enumerate(fused_nerf.backbone_f32_weights(cfg, packed)):
        big_ref, small_ref = fused_nerf.tf32_split(w)
        base = 2 * width * sum(in_pad[:i])
        for c in range(width // np_):
            for s in range(in_pad[i] // 8):
                big, small = slot_matrix(buffers.fwd, base + (c * in_pad[i] // 8 + s) * 16 * np_, np_)
                cols = slice(np_ * c, np_ * c + np_)
                assert torch.equal(big, big_ref[8 * s + order, cols]) and torch.equal(small, small_ref[8 * s + order, cols])
        offset = base
        groups = [(in_pad[i] - pe_pad + 64 * e, 64) for e in range(4)] if i in (0, skip) else []
        groups += [(np_ * c, np_) for c in range(width // np_)] if i > 0 else []
        for row0, rows in groups:
            for k in range(width // 8):
                big, small = slot_matrix(buffers.bwd, offset, rows)
                assert torch.equal(big, big_ref[row0: row0 + rows, 8 * k + order].t()), (i, row0, k)
                assert torch.equal(small, small_ref[row0: row0 + rows, 8 * k + order].t()), (i, row0, k)
                offset += 16 * rows
        assert offset == base + 2 * width * in_pad[i]


@pytest.mark.parametrize("layers", [16, 17, 40])
def test_f32_pack_launches_cover_a_deep_network(layers):
    """backbone_f32_pack_launch packs a network in launches of at most 16
    layers (the pointers of one kernel parameter): each launch's padded rows
    [row0, row0 + rows), its biases and, on the last, b_alpha and w_alpha;
    together every padded row, bias and w_alpha element once."""
    width, skip, pe_pad = 256, layers // 2, 64
    in_pad = [pe_pad if i == 0 else width + (pe_pad if i == skip else 0) for i in range(layers)]
    rows = torch.zeros(sum(in_pad), dtype=torch.int64)
    biases = torch.zeros(layers * width + 1, dtype=torch.int64)
    w_alpha = 0
    for first in range(0, layers, 16):
        count = min(16, layers - first)
        last = first + count == layers
        row0, n = sum(in_pad[:first]), sum(in_pad[first: first + count])
        rows[row0: row0 + n] += 1
        biases[first * width: (first + count) * width] += 1
        if last:
            biases[layers * width] += 1
            w_alpha += 1
    assert bool((rows == 1).all()) and bool((biases == 1).all()) and w_alpha == 1
    assert len(range(0, layers, 16)) == -(-layers // 16)
