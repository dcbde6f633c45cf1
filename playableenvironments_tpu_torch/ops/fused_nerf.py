"""The eval AdaIN-NeRF MLP as one hand-written CUDA kernel.

Port of playableenvironments_tpu/ops/fused_nerf.py's inference half: the
per-point pipeline 8x256 backbone with mid skip -> alpha head +
AdaIN-modulated feature head, over pre-encoded points, with eval-mode BN
statistics folded into a per-ray scale/bias. The kernel is
csrc/fused_nerf.cu (sm_90a, bf16 tensor cores, f32 accumulation), built with
nvcc at first use and loaded with ctypes.

`fused_adain_nerf` launches it for CUDA tensors. For CPU tensors it runs
`plain_adain_nerf`, the bf16-emulating PyTorch version of the same function
(matmul operands rounded to bf16, products and sums in f32), which is what
the CPU tests compare against the JAX package and what the card compares
the kernel with.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

import torch

from playableenvironments_tpu_torch.config import NerfMLPConfig
from playableenvironments_tpu_torch.core.bbox import aabb_contains, aabb_size
from playableenvironments_tpu_torch.models.encoding import positional_encoding

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_nerf.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# Limits of the kernel's shared-memory layout (csrc/fused_nerf.cu).
_MAX_WIDTH = 256
_MAX_PE = 64


def fold_adain_stats(adain, style: torch.Tensor, eps: float = 1e-5):
    """Fold eval-mode BN running stats into the AdaIN affine:
    scale' = scale * rsqrt(var + eps), bias' = bias - mean * scale'.

    :param adain: models.layers.AffineTransformAdaIn.
    :param style: (..., style_features).
    :return: ((..., features) scale', (..., features) bias').
    """
    encoded = style @ adain.affine.weight.t() + adain.affine.bias
    scale, bias = torch.chunk(encoded, 2, dim=-1)
    scale_eff = scale * torch.rsqrt(adain.norm.var + eps)
    bias_eff = bias - adain.norm.mean * scale_eff
    return scale_eff, bias_eff


def pack_nerf_params(cfg: NerfMLPConfig, nerf) -> Dict[str, torch.Tensor]:
    """The AdaInNerfMLP's weights in the JAX package's packed layout:
    w{i}/b{i}, w_alpha/b_alpha, w_f0, w_f1, w_out/b_out, each weight (in, out)."""
    packed = {}
    for i in range(cfg.backbone_layers_count):
        layer = getattr(nerf, f"backbone_{i}")
        packed[f"w{i}"] = layer.weight.t()
        packed[f"b{i}"] = layer.bias
    packed["w_alpha"] = nerf.alpha_head.weight.t()
    packed["b_alpha"] = nerf.alpha_head.bias
    packed["w_f0"] = nerf.feat_0.weight.t()
    packed["w_f1"] = nerf.feat_1.weight.t()
    packed["w_out"] = nerf.feat_out.weight.t()
    packed["b_out"] = nerf.feat_out.bias
    return packed


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def plain_adain_nerf(
    cfg: NerfMLPConfig,
    packed: Dict[str, torch.Tensor],
    encoded: torch.Tensor,
    scale0: torch.Tensor,
    bias0: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    samples_per_ray: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: every matmul operand rounded
    to bf16, products and sums in f32, modulation per ray (rows of
    scale*/bias* broadcast over `samples_per_ray` consecutive points).

    :return: ((N, output_features) features, (N,) raw alpha).
    """

    def mm(x, w):
        return _bf16(x) @ _bf16(w)

    def per_point(mod):
        return mod.repeat_interleave(samples_per_ray, dim=0)

    encoded = _bf16(encoded.float())
    h = encoded
    for i in range(cfg.backbone_layers_count):
        if i == cfg.skip_layer_idx:
            h = torch.cat([h, encoded], dim=-1)
        h = torch.relu(mm(h, packed[f"w{i}"]) + packed[f"b{i}"])
    alpha = (mm(h, packed["w_alpha"]) + packed["b_alpha"])[..., 0]
    f = torch.relu(mm(h, packed["w_f0"]) * per_point(scale0) + per_point(bias0))
    f = torch.relu(mm(f, packed["w_f1"]) * per_point(scale1) + per_point(bias1))
    return mm(f, packed["w_out"]) + packed["b_out"], alpha


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


@dataclass(frozen=True)
class NerfKernelWeights:
    """One object's MLP weights: `packed` in the JAX layout (what the plain
    version reads) and the same weights as the kernel's flat buffers (bf16
    matrices zero-padded to multiples of 16, f32 biases; the order is
    documented in csrc/fused_nerf.cu)."""

    packed: Dict[str, torch.Tensor]
    weights: torch.Tensor
    biases: torch.Tensor
    pe: int


def kernel_weights(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> NerfKernelWeights:
    """Pack and pad `packed` once into the kernel's buffers (on the weights'
    device). Raises for widths the kernel's layout does not take."""
    width = cfg.layers_width
    layers = cfg.backbone_layers_count
    skip = cfg.skip_layer_idx
    pe = packed["w0"].shape[0]
    out = packed["w_out"].shape[1]
    if width % 32 or width > _MAX_WIDTH:
        raise ValueError(f"layers_width {width} must be a multiple of 32, at most {_MAX_WIDTH}")
    if pe > _MAX_PE:
        raise ValueError(f"encoding width {pe} exceeds the kernel's {_MAX_PE}")
    if out > _MAX_WIDTH:
        raise ValueError(f"output_features {out} exceeds the kernel's {_MAX_WIDTH}")
    if skip == 0:
        raise ValueError("skip_layer_idx 0 (skip into the first layer) is not supported")
    pe_pad = _round16(pe)

    def padded(w, rows, cols):
        z = w.new_zeros((rows, cols))
        z[: w.shape[0], : w.shape[1]] = w
        return z

    with torch.no_grad():
        mats = []
        for i in range(layers):
            w = packed[f"w{i}"]
            if i == 0:
                mats.append(padded(w, pe_pad, width))
            elif i == skip:
                mats.append(torch.cat([w[:width], padded(w[width:], pe_pad, width)]))
            else:
                mats.append(w)
        mats += [
            packed["w_alpha"].reshape(1, width),
            packed["w_f0"],
            packed["w_f1"],
            padded(packed["w_out"], width // 2, _round16(out)),
        ]
        weights = torch.cat([m.reshape(-1) for m in mats]).to(torch.bfloat16).contiguous()
        biases = torch.cat(
            [packed[f"b{i}"] for i in range(layers)] + [packed["b_alpha"], packed["b_out"]]
        ).to(torch.float32).contiguous()
    return NerfKernelWeights(
        packed={k: v.detach() for k, v in packed.items()},
        weights=weights,
        biases=biases,
        pe=pe,
    )


def _library_path() -> Path:
    digest = hashlib.sha1(_SOURCE.read_bytes()).hexdigest()[:12]
    return _BUILD_DIR / f"fused_nerf-{digest}.so"


def build_kernel() -> str:
    """Compile csrc/fused_nerf.cu with nvcc for sm_90a into the build
    directory, once per source content.

    :return: nvcc's report (registers, shared memory, spills), or "" when the
        library was already built.
    """
    lib_path = _library_path()
    if lib_path.exists():
        return ""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build csrc/fused_nerf.cu")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(_SOURCE),
    ]
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed:\n{result.stdout}\n{result.stderr}")
    os.replace(tmp, lib_path)
    return result.stdout + result.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process. Reached only when
    a CUDA tensor reaches the kernel."""
    build_kernel()
    lib = ctypes.CDLL(str(_library_path()))
    fn = lib.fused_adain_nerf_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fused_adain_nerf(
    cfg: NerfMLPConfig,
    weights: NerfKernelWeights,
    encoded: torch.Tensor,
    scale0: torch.Tensor,
    bias0: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    samples_per_ray: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MLP over pre-encoded points, ray-major (N = rays * samples_per_ray).

    :param encoded: (N, pe) encodings (rounded to bf16 here).
    :param scale0/bias0: (N / samples_per_ray, W) f32 per-ray modulation;
        scale1/bias1 (N / samples_per_ray, W // 2).
    :return: ((N, output_features) f32 features, (N,) f32 raw alpha).

    CPU tensors take `plain_adain_nerf`. CUDA tensors launch the kernel
    (counted in `fused_adain_nerf.launches`); any other device, or a failed
    build or launch, raises.
    """
    n, pe = encoded.shape
    width = cfg.layers_width
    if samples_per_ray < 1 or n % samples_per_ray:
        raise ValueError(f"point count {n} not divisible by samples {samples_per_ray}")
    rays = n // samples_per_ray
    for name, t, cols in (
        ("scale0", scale0, width), ("bias0", bias0, width),
        ("scale1", scale1, width // 2), ("bias1", bias1, width // 2),
    ):
        if tuple(t.shape) != (rays, cols):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(rays, cols)}")
    if pe != weights.pe:
        raise ValueError(f"encoding width {pe} != the weights' {weights.pe}")

    if encoded.device.type == "cpu":
        return plain_adain_nerf(
            cfg, weights.packed, encoded, scale0, bias0, scale1, bias1, samples_per_ray
        )
    if encoded.device.type != "cuda":
        raise ValueError(f"fused_adain_nerf runs on cuda or cpu tensors, not {encoded.device}")

    device = encoded.device
    mods = [scale0, bias0, scale1, bias1]
    for t in mods + [weights.weights, weights.biases]:
        if t.device != device:
            raise ValueError(f"all inputs must be on {device}, got one on {t.device}")
    for t in mods:
        if t.dtype != torch.float32:
            raise ValueError(f"modulation must be float32, got {t.dtype}")
    encoded = encoded.to(torch.bfloat16).contiguous()
    mods = [t.contiguous() for t in mods]
    out_features = weights.packed["w_out"].shape[1]
    features = torch.empty((n, out_features), dtype=torch.float32, device=device)
    alpha = torch.empty((n,), dtype=torch.float32, device=device)
    if n == 0:
        return features, alpha

    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.fused_adain_nerf_launch(
        encoded.data_ptr(), *(t.data_ptr() for t in mods),
        weights.weights.data_ptr(), weights.biases.data_ptr(),
        features.data_ptr(), alpha.data_ptr(),
        n, samples_per_ray, pe, width, cfg.backbone_layers_count,
        cfg.skip_layer_idx, out_features, stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_adain_nerf kernel launch failed with CUDA error {err}")
    fused_adain_nerf.launches += 1
    return features, alpha


fused_adain_nerf.launches = 0


def fused_object_field_eval(
    cfg: NerfMLPConfig,
    bounding_box,
    nerf,
    positions: torch.Tensor,
    style: torch.Tensor,
    empty_space_alpha: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode object field through the fused MLP: bbox mask, bbox
    normalization and positional encoding here, the MLP in the kernel,
    empty-space masking after.

    :param nerf: models.nerf.AdaInNerfMLP.
    :param positions: (..., rays, samples, 3) object-frame points.
    :param style: (..., rays, 1, style_features), constant along each ray.
    :return: ((..., rays, samples, F) features, (..., rays, samples) raw alphas).
    """
    box = torch.as_tensor(bounding_box, dtype=positions.dtype, device=positions.device)
    mask = aabb_contains(box, positions)

    batch_shape = positions.shape[:-1]
    samples_per_ray = positions.shape[-2]
    ray_shape = batch_shape[:-1]
    flat_positions = positions.reshape(-1, 3)
    style_rays = style[..., 0, :].expand(ray_shape + style.shape[-1:])
    flat_style = style_rays.reshape(-1, style.shape[-1])

    pe_cfg = cfg.position_encoder
    encoded = positional_encoding(
        flat_positions / aabb_size(box), pe_cfg.octaves, pe_cfg.append_original
    )
    scale0, bias0 = fold_adain_stats(nerf.adain_0, flat_style)
    scale1, bias1 = fold_adain_stats(nerf.adain_1, flat_style)

    features, alpha = fused_adain_nerf(
        cfg, nerf.kernel_weights(), encoded, scale0, bias0, scale1, bias1,
        samples_per_ray=samples_per_ray,
    )
    features = features.reshape(batch_shape + (features.shape[-1],))
    alpha = alpha.reshape(batch_shape)
    features = torch.where(mask[..., None], features, 0.0)
    alpha = torch.where(mask, alpha, float(empty_space_alpha))
    return features, alpha
