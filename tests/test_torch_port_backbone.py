"""The port's trainable fused backbone (ops/fused_nerf.py::fused_backbone)
against the JAX package's custom-VJP `fused_backbone`, whose forward and
backward Pallas kernels run in interpret mode here: outputs and the vjp of
random cotangents (d_encoded and every weight and bias gradient), with a
ragged point count, in f32 (1e-5 relative to each output's largest
magnitude: the same products, summed in another order) and in bf16 (5e-3,
as B1's: the same bf16 operand rounding, and another f32 summation order
can flip an occasional bf16 rounding). The kernels' flat layouts are checked
on the CPU by reading them as csrc/fused_backbone.cu does; the kernels
themselves run only on a card (test_torch_port_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.ops import fused_nerf as jax_fused
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.ops import fused_nerf

KW = dict(layers_width=32, backbone_layers_count=4, skip_layer_idx=2, output_features=3,
          position_encoder=dict(octaves=2))


def configs(compute_dtype):
    kw = dict(KW, compute_dtype=compute_dtype, use_fused_backbone=True)
    pe = kw.pop("position_encoder")
    return (jax_config.NerfMLPConfig(position_encoder=jax_config.PositionalEncoderConfig(**pe), **kw),
            port_config.NerfMLPConfig(position_encoder=port_config.PositionalEncoderConfig(**pe), **kw))


def inputs(cfg, n, pe=15, seed=0):
    rng = np.random.default_rng(seed)
    packed = {}
    for i, w_in in enumerate(fused_nerf._backbone_sizes(cfg, pe)):
        packed[f"w{i}"] = (rng.normal(size=(w_in, cfg.layers_width)) / np.sqrt(w_in)).astype(np.float32)
        packed[f"b{i}"] = (rng.normal(size=(cfg.layers_width,)) * 0.1).astype(np.float32)
    packed["w_alpha"] = (rng.normal(size=(cfg.layers_width, 1)) * 0.2).astype(np.float32)
    packed["b_alpha"] = np.asarray([0.1], np.float32)
    encoded = rng.uniform(-1, 1, (n, pe)).astype(np.float32)
    g_h = rng.normal(size=(n, cfg.layers_width)).astype(np.float32)
    g_alpha = rng.normal(size=(n,)).astype(np.float32)
    return packed, encoded, g_h, g_alpha


def relative_close(got, ref, tol, name):
    ref = np.asarray(ref).reshape(np.shape(got))
    scale = np.abs(ref).max()
    assert scale > 0, name
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-3)])
@pytest.mark.parametrize("n", [700, 64])
def test_fused_backbone_and_its_vjp_match_jax(compute_dtype, tol, n):
    """700 points: two 512-point JAX blocks, the last one ragged."""
    jcfg, cfg = configs(compute_dtype)
    packed, encoded, g_h, g_alpha = inputs(cfg, n)
    jpacked = {k: jnp.asarray(v) for k, v in packed.items()}
    (jh, ja), vjp = jax.vjp(lambda p, e: jax_fused.fused_backbone(jcfg, p, e, 512, True), jpacked, jnp.asarray(encoded))
    jd_packed, jd_encoded = vjp((jnp.asarray(g_h), jnp.asarray(g_alpha)))

    tpacked = {k: torch.tensor(v, requires_grad=True) for k, v in packed.items()}
    tencoded = torch.tensor(encoded, requires_grad=True)
    h, alpha = fused_nerf.fused_backbone(cfg, tpacked, tencoded)
    torch.autograd.backward([h, alpha], [torch.from_numpy(g_h), torch.from_numpy(g_alpha)])
    relative_close(h.detach(), jh, tol, "h")
    relative_close(alpha.detach(), ja, tol, "alpha")
    relative_close(tencoded.grad, jd_encoded, tol, "d_encoded")
    for name, value in tpacked.items():
        relative_close(value.grad, jd_packed[name], tol, name)


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """In f32 the explicit backward equals autograd through the forward."""
    _, cfg = configs("float32")
    packed, encoded, g_h, g_alpha = inputs(cfg, 50, seed=1)
    tpacked = {k: torch.tensor(v, requires_grad=True) for k, v in packed.items()}
    tencoded = torch.tensor(encoded, requires_grad=True)
    h, alpha = fused_nerf.plain_backbone_fwd(cfg, tpacked, tencoded)
    torch.autograd.backward([h, alpha], [torch.from_numpy(g_h), torch.from_numpy(g_alpha)])
    grads, d_encoded = fused_nerf.plain_backbone_bwd(
        cfg, {k: torch.from_numpy(v) for k, v in packed.items()}, torch.from_numpy(encoded),
        torch.from_numpy(g_h), torch.from_numpy(g_alpha))
    torch.testing.assert_close(d_encoded, tencoded.grad, rtol=1e-5, atol=1e-6)
    for name, value in tpacked.items():
        torch.testing.assert_close(grads[name].reshape(value.shape), value.grad, rtol=1e-5, atol=1e-6)


def test_sizes_and_weight_list_match_jax():
    jcfg, cfg = configs("bfloat16")
    assert fused_nerf._backbone_sizes(cfg, 15) == jax_fused._backbone_sizes(jcfg, 15) == [15, 32, 47, 32]
    packed, *_ = inputs(cfg, 4)
    jlist = jax_fused._weight_list(jcfg, {k: jnp.asarray(v) for k, v in packed.items()})
    tlist = fused_nerf._weight_list(cfg, {k: torch.from_numpy(v) for k, v in packed.items()})
    assert [tuple(w.shape) for w in tlist] == [tuple(w.shape) for w in jlist]
    for w, jw in zip(tlist, jlist):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


@pytest.mark.parametrize("layers,width,skip,pe", [(4, 64, 2, 15), (8, 256, 4, 63), (3, 128, 1, 64)])
def test_kernel_layouts(layers, width, skip, pe):
    """The weight buffer read with csrc/fused_backbone.cu's offsets gives the
    plain forward; the kernels' flat gradient output, written in its padded
    row order, unpacks to the plain gradients."""
    cfg = port_config.NerfMLPConfig(layers_width=width, backbone_layers_count=layers, skip_layer_idx=skip,
                                    compute_dtype="bfloat16", use_fused_backbone=True)
    packed, encoded, g_h, g_alpha = (torch.from_numpy(np.asarray(x)) if not isinstance(x, dict)
                                     else {k: torch.from_numpy(v) for k, v in x.items()}
                                     for x in inputs(cfg, 40, pe=pe, seed=2))
    weights, biases = fused_nerf.backbone_buffers(cfg, packed)
    w = weights.float()
    kpe = 64
    a = torch.zeros(40, width + kpe)
    a[:, width : width + pe] = encoded.to(torch.bfloat16).float()
    offset, rows_total = 0, 0
    for i in range(layers):
        k = kpe if i == 0 else (width + kpe if i == skip else width)
        lhs = a[:, width:] if i == 0 else a[:, :k]
        h = torch.relu(lhs @ w[offset : offset + k * width].reshape(k, width) + biases[i * width : (i + 1) * width])
        a[:, :width] = h.to(torch.bfloat16).float()
        offset += k * width
        rows_total += k
    alpha = a[:, :width] @ w[offset : offset + width] + biases[layers * width]
    assert offset + width == w.numel() and biases.numel() == layers * width + 1
    ref_h, ref_alpha = fused_nerf.plain_backbone_fwd(cfg, packed, encoded)
    torch.testing.assert_close(h, ref_h, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(alpha, ref_alpha, rtol=1e-4, atol=1e-4)

    grads, _ = fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
    assert fused_nerf._backbone_grad_rows(cfg) == rows_total
    rows = []
    for i in range(layers):
        dw = grads[f"w{i}"]
        if i == 0:
            rows.append(fused_nerf._padded(dw, kpe, width))
        elif i == skip:
            rows += [dw[:width], fused_nerf._padded(dw[width:], kpe, width)]
        else:
            rows.append(dw)
    flat = torch.cat([torch.cat(rows).reshape(-1)] + [grads[f"b{i}"] for i in range(layers)]
                     + [grads["w_alpha"].reshape(-1), grads["b_alpha"]])
    unpacked = fused_nerf._unpack_backbone_grads(cfg, flat, pe)
    assert set(unpacked) == set(grads)
    for name, value in grads.items():
        assert torch.equal(unpacked[name].reshape(value.shape), value), name


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, cfg = configs("bfloat16")
    packed, encoded, g_h, g_alpha = inputs(cfg, 8)
    meta = {k: torch.from_numpy(v).to("meta") for k, v in packed.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_nerf.fused_backbone_fwd(cfg, meta, torch.from_numpy(encoded).to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_nerf.fused_backbone_bwd(cfg, meta, *(torch.from_numpy(x).to("meta") for x in (encoded, g_h, g_alpha)))
