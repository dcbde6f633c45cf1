"""The AdaIN-NeRF MLP's hand-written CUDA kernels.

Port of playableenvironments_tpu/ops/fused_nerf.py:
- the inference half, `fused_adain_nerf`: the per-point pipeline 8x256
  backbone with mid skip -> alpha head + AdaIN-modulated feature head, over
  pre-encoded points, with eval-mode BN statistics folded into a per-ray
  scale/bias (csrc/fused_nerf.cu);
- the trainable backbone, `fused_backbone`: backbone + alpha head as a
  torch.autograd.Function whose forward (`fused_backbone_fwd`) and backward
  (`fused_backbone_bwd`) are kernels (csrc/fused_backbone.cu).
Both sources are sm_90a, bf16 tensor cores with f32 accumulation, built with
nvcc at first use and loaded with ctypes.

Each wrapper launches its kernel for CUDA tensors. For CPU tensors it runs
the plain PyTorch version of the same function (`plain_adain_nerf`,
`plain_backbone_fwd`, `plain_backbone_bwd`: matmul operands rounded to the
compute dtype, products and sums in f32), which is what the CPU tests
compare against the JAX package and what the card compares the kernels with.
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
from typing import Dict, List, Tuple

import torch

from playableenvironments_tpu_torch.config import NerfMLPConfig
from playableenvironments_tpu_torch.core.bbox import aabb_contains, aabb_size
from playableenvironments_tpu_torch.models.encoding import positional_encoding

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_nerf.cu"
_BACKBONE_SOURCE = _SOURCE.with_name("fused_backbone.cu")
_ROLLOUT_SOURCE = _SOURCE.with_name("fused_rollout.cu")  # B4/B5, wrapped in ops/fused_rollout.py
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


def _padded(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """`w` in the top-left corner of a (rows, cols) zero matrix."""
    z = w.new_zeros((rows, cols))
    z[: w.shape[0], : w.shape[1]] = w
    return z


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

    with torch.no_grad():
        mats = []
        for i in range(layers):
            w = packed[f"w{i}"]
            if i == 0:
                mats.append(_padded(w, pe_pad, width))
            elif i == skip:
                mats.append(torch.cat([w[:width], _padded(w[width:], pe_pad, width)]))
            else:
                mats.append(w)
        mats += [
            packed["w_alpha"].reshape(1, width),
            packed["w_f0"],
            packed["w_f1"],
            _padded(packed["w_out"], width // 2, _round16(out)),
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


def _library_path(source: Path) -> Path:
    digest = hashlib.sha1(source.read_bytes()).hexdigest()[:12]
    return _BUILD_DIR / f"{source.stem}-{digest}.so"


def build_kernels(sources: Tuple[Path, ...] = (_SOURCE, _BACKBONE_SOURCE, _ROLLOUT_SOURCE)) -> Dict[str, str]:
    """Compile each CUDA source with nvcc for sm_90a into the build
    directory, once per source content; the nvcc processes run together.

    :return: {source name: nvcc's report (registers, shared memory, spills)},
        "" for a library that was already built.
    """
    todo = [s for s in sources if not _library_path(s).exists()]
    if not todo:
        return {s.name: "" for s in sources}
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(source),
        ]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((source, tmp, proc))
    reports, failures = {s.name: "" for s in sources}, []
    for source, tmp, proc in jobs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {source.name}:\n{output}")
        else:
            os.replace(tmp, _library_path(source))
            reports[source.name] = output
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def _load(source: Path) -> ctypes.CDLL:
    build_kernels((source,))
    return ctypes.CDLL(str(_library_path(source)))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process. Reached only when
    a CUDA tensor reaches the kernel."""
    lib = _load(_SOURCE)
    fn = lib.fused_adain_nerf_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _backbone_library() -> ctypes.CDLL:
    """csrc/fused_backbone.cu, built and loaded once per process."""
    lib = _load(_BACKBONE_SOURCE)
    lib.fused_backbone_fwd_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.fused_backbone_bwd_launch.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                                              + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)])
    lib.fused_backbone_fwd_launch.restype = ctypes.c_int
    lib.fused_backbone_bwd_launch.restype = ctypes.c_int
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


# ---------------------------------------------------------------------------
# Trainable fused backbone (the JAX package's custom-VJP `fused_backbone`)
# ---------------------------------------------------------------------------

# The backbone kernels pad the encoding to this many columns, work on tiles
# of this many points, and keep the ReLU masks of at most this many layers in
# shared memory (csrc/fused_backbone.cu: kPe, kTile, kMaxLayers). Weights and
# scratch are arrays of 64 x 64 bf16 blocks in wgmma's 128-byte swizzle.
_BACKBONE_PE = 64
_BACKBONE_TILE = 128
_BACKBONE_MAX_LAYERS = 8
_BLOCK = 64


def _backbone_sizes(cfg: NerfMLPConfig, encoded_size: int) -> List[int]:
    """Input width of each backbone layer (the skip layer takes h ++ encoding)."""
    widths_in = []
    for i in range(cfg.backbone_layers_count):
        w_in = encoded_size if i == 0 else cfg.layers_width
        if i == cfg.skip_layer_idx and i != 0:
            w_in += encoded_size
        widths_in.append(w_in)
    return widths_in


def _backbone_names(cfg: NerfMLPConfig) -> List[str]:
    names = []
    for i in range(cfg.backbone_layers_count):
        names += [f"w{i}", f"b{i}"]
    return names + ["w_alpha", "b_alpha"]


def _weight_list(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """[w0, b0 (1, W), ..., w_alpha (W, 1), b_alpha (1, 1)], the JAX kernels'
    argument order."""
    return [
        packed[name].reshape(1, -1) if name.startswith("b") else packed[name]
        for name in _backbone_names(cfg)
    ]


def _operand_rounding(cfg: NerfMLPConfig):
    """x -> x rounded to the matmul operand dtype, kept in x's dtype (f32,
    or f64 for a reference with f64 sums)."""
    if cfg.compute_dtype == "float32":
        return lambda x: x
    dtype = getattr(torch, cfg.compute_dtype)
    return lambda x: x.to(dtype).to(x.dtype)


def _plain_backbone_acts(cfg, packed, encoded, rnd) -> List[torch.Tensor]:
    acts, h = [], encoded
    for i in range(cfg.backbone_layers_count):
        if i == cfg.skip_layer_idx and i != 0:
            h = torch.cat([h, encoded], dim=-1)
        h = torch.relu(rnd(h) @ rnd(packed[f"w{i}"]) + packed[f"b{i}"])
        acts.append(h)
    return acts


def plain_backbone_fwd(
    cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backbone + alpha head in plain PyTorch, as the TPU forward kernel
    computes it: matmul operands rounded to `compute_dtype`, everything else
    f32.

    :param packed: w{i} (in_i, W), b{i} (W,), w_alpha (W, 1), b_alpha (1,).
    :param encoded: (N, E) f32 encodings.
    :return: ((N, W) post-ReLU h, (N,) raw alpha).
    """
    rnd = _operand_rounding(cfg)
    h = _plain_backbone_acts(cfg, packed, encoded, rnd)[-1]
    alpha = rnd(h) @ rnd(packed["w_alpha"]) + packed["b_alpha"]
    return h, alpha[:, 0]


def plain_backbone_bwd(
    cfg: NerfMLPConfig,
    packed: Dict[str, torch.Tensor],
    encoded: torch.Tensor,
    g_h: torch.Tensor,
    g_alpha: torch.Tensor,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The TPU backward kernel's explicit backward in plain PyTorch (not
    autograd): recompute the activations, back-propagate through the ReLU
    chain, split the skip layer's input gradient.

    :param g_h: (N, W) cotangent of h; :param g_alpha: (N,) of alpha.
    :return: ({name: gradient in that weight's shape}, (N, E) d_encoded).
    """
    rnd = _operand_rounding(cfg)
    layers, width = cfg.backbone_layers_count, cfg.layers_width
    acts = _plain_backbone_acts(cfg, packed, encoded, rnd)
    g_alpha = g_alpha[:, None]
    grads = {
        "w_alpha": rnd(acts[-1]).t() @ rnd(g_alpha),
        "b_alpha": g_alpha.sum(dim=0),
    }
    g = g_h + rnd(g_alpha) @ rnd(packed["w_alpha"]).t()
    d_encoded = torch.zeros_like(encoded)
    for i in range(layers - 1, -1, -1):
        g = g * (acts[i] > 0.0)
        if i == 0:
            layer_in = encoded
        elif i == cfg.skip_layer_idx:
            layer_in = torch.cat([acts[i - 1], encoded], dim=-1)
        else:
            layer_in = acts[i - 1]
        grads[f"w{i}"] = rnd(layer_in).t() @ rnd(g)
        grads[f"b{i}"] = g.sum(dim=0)
        g_in = rnd(g) @ rnd(packed[f"w{i}"]).t()
        if i == 0:
            d_encoded = d_encoded + g_in
        elif i == cfg.skip_layer_idx:
            d_encoded = d_encoded + g_in[:, width:]
            g = g_in[:, :width]
        else:
            g = g_in
    return grads, d_encoded


def _layer_slots(cfg: NerfMLPConfig) -> List[List[Tuple[int, int]]]:
    """For each layer, its slots of the weight image in order, each as
    (first weight row, rows): 64 input rows of the layer's (in, W) matrix,
    the encoding's rows zero-padded to 64 (csrc/fused_backbone.cu)."""
    width, skip = cfg.layers_width, cfg.skip_layer_idx
    layers = []
    for i in range(cfg.backbone_layers_count):
        if i == 0:
            layers.append([(0, _BACKBONE_PE)])
        else:
            slots = [(r, _BLOCK) for r in range(0, width, _BLOCK)]
            if i == skip:
                slots.append((width, _BACKBONE_PE))
            layers.append(slots)
    return layers


def swizzled(row, col):
    """Element offset of (row, col) in a 64 x 64 bf16 block of wgmma's
    128-byte swizzle: row r holds 128 bytes whose 16-byte chunks are XOR-ed
    with r % 8."""
    return row * _BLOCK + ((col // 8) ^ (row % 8)) * 8 + col % 8


def backbone_buffers(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backbone's weights as csrc/fused_backbone.cu reads them: the bf16
    weight image (every layer's 64-row slots, each W/64 swizzled 64 x 64
    blocks, then w_alpha) and the f32 biases b_0 .. b_{L-1}, b_alpha. A
    handful of small kernels a launch: the slots' rows in one cat, one
    cast, one gather for the swizzle."""
    width = cfg.layers_width
    with torch.no_grad():
        rows = []
        for i, layer in enumerate(_layer_slots(cfg)):
            w = packed[f"w{i}"]
            for first, count in layer:
                block = w[first : first + count]  # fewer than 64 rows only for the encoding's
                pad = _BLOCK - block.shape[0]
                rows.append(torch.nn.functional.pad(block, (0, 0, 0, pad)) if pad else block)
        slots = torch.cat(rows).to(torch.bfloat16).reshape(-1, _BLOCK, width // _BLOCK, _BLOCK)
        blocks = slots.permute(0, 2, 1, 3).reshape(-1, _BLOCK * _BLOCK)
        image = blocks[:, _unswizzle(blocks.device)]
        weights = torch.cat([image.reshape(-1), packed["w_alpha"].reshape(-1).to(torch.bfloat16)])
        biases = torch.cat(
            [packed[f"b{i}"].reshape(-1) for i in range(cfg.backbone_layers_count)]
            + [packed["b_alpha"].reshape(-1)]
        ).to(torch.float32).contiguous()
    return weights, biases


@functools.lru_cache(maxsize=None)
def _unswizzle(device: torch.device) -> torch.Tensor:
    """For each element of a swizzled 64 x 64 block, the row-major index of
    the element it holds (the inverse of `swizzled`)."""
    r, c = torch.meshgrid(torch.arange(_BLOCK), torch.arange(_BLOCK), indexing="ij")
    index = torch.empty(_BLOCK * _BLOCK, dtype=torch.int64)
    index[swizzled(r, c).reshape(-1)] = torch.arange(_BLOCK * _BLOCK)
    return index.to(device)


def _kernel_skip(cfg: NerfMLPConfig) -> int:
    """The skip layer as the kernels take it: skip_layer_idx 0 means no
    skip (as in _backbone_sizes), which the kernels read as `layers`."""
    return cfg.skip_layer_idx or cfg.backbone_layers_count


def _backbone_kernel_checks(cfg: NerfMLPConfig, encoded: torch.Tensor, tensors) -> None:
    """Raises for what the kernels do not take: `tensors` must be f32 on
    the card of `encoded`."""
    if encoded.device.type != "cuda":
        raise ValueError(f"the fused backbone runs on cuda or cpu tensors, not {encoded.device}")
    if cfg.compute_dtype != "bfloat16":
        raise NotImplementedError(
            f"the backbone kernels take bfloat16 operands; compute_dtype {cfg.compute_dtype!r} "
            "has no kernel path on the card yet"
        )
    width = cfg.layers_width
    if width % 64 or width > _MAX_WIDTH:
        raise ValueError(f"layers_width {width} must be a multiple of 64, at most {_MAX_WIDTH}")
    if encoded.shape[1] > _BACKBONE_PE:
        raise ValueError(f"encoding width {encoded.shape[1]} exceeds the kernel's {_BACKBONE_PE}")
    if cfg.backbone_layers_count > _BACKBONE_MAX_LAYERS:
        raise ValueError(f"{cfg.backbone_layers_count} backbone layers exceed the kernel's {_BACKBONE_MAX_LAYERS}")
    for t in tensors:
        if t.device != encoded.device or t.dtype != torch.float32:
            raise ValueError(f"inputs must be float32 on {encoded.device}, got {t.dtype} on {t.device}")


def fused_backbone_fwd(
    cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor, buffers=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone + alpha head over (N, E) f32 encodings -> ((N, W) h, (N,) alpha).

    CPU tensors take `plain_backbone_fwd`. CUDA tensors launch the forward
    kernel (counted in `fused_backbone_fwd.launches`) on `buffers`, the
    (weights, biases) of `backbone_buffers`, built here when not given; any
    other device, an unsupported configuration, or a failed build or launch
    raises.
    """
    if encoded.device.type == "cpu":
        return plain_backbone_fwd(cfg, packed, encoded)
    _backbone_kernel_checks(cfg, encoded, [encoded] + list(packed.values()))
    n, pe = encoded.shape
    width = cfg.layers_width
    weights, biases = buffers if buffers is not None else backbone_buffers(cfg, packed)
    encoded = encoded.contiguous()
    h = torch.empty((n, width), dtype=torch.float32, device=encoded.device)
    alpha = torch.empty((n,), dtype=torch.float32, device=encoded.device)
    if n == 0:
        return h, alpha
    lib = _backbone_library()
    err = lib.fused_backbone_fwd_launch(
        encoded.data_ptr(), weights.data_ptr(), biases.data_ptr(), h.data_ptr(), alpha.data_ptr(),
        n, pe, width, cfg.backbone_layers_count, _kernel_skip(cfg), backbone_grid(n, _sm_count(encoded.device)),
        torch.cuda.current_stream(encoded.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_backbone_fwd kernel launch failed with CUDA error {err}")
    fused_backbone_fwd.launches += 1
    return h, alpha


fused_backbone_fwd.launches = 0


def _backbone_grad_rows(cfg: NerfMLPConfig) -> int:
    """Rows of the kernel's padded weight-gradient matrix."""
    width, skip = cfg.layers_width, cfg.skip_layer_idx
    rows = 0
    for i in range(cfg.backbone_layers_count):
        rows += _BACKBONE_PE if i == 0 else (width + _BACKBONE_PE if i == skip else width)
    return rows


def _unpack_backbone_grads(cfg: NerfMLPConfig, grads_out: torch.Tensor, pe: int) -> Dict[str, torch.Tensor]:
    """The backward kernels' flat f32 output -> {name: gradient}: the weight
    gradients as (rows, W) in the padded row order of backbone_buffers, then
    db_0 .. db_{L-1}, dW_alpha (W), db_alpha (1)."""
    width, layers, skip = cfg.layers_width, cfg.backbone_layers_count, cfg.skip_layer_idx
    rows_pad = _backbone_grad_rows(cfg)
    dw = grads_out[: rows_pad * width].view(rows_pad, width)
    small = grads_out[rows_pad * width :]
    grads, start = {}, 0
    for i in range(layers):
        if i == 0:
            grads["w0"] = dw[:pe]
            start = _BACKBONE_PE
        elif i == skip:
            grads[f"w{i}"] = torch.cat([dw[start : start + width], dw[start + width : start + width + pe]])
            start += width + _BACKBONE_PE
        else:
            grads[f"w{i}"] = dw[start : start + width]
            start += width
        grads[f"b{i}"] = small[i * width : (i + 1) * width]
    grads["w_alpha"] = small[layers * width : layers * width + width].reshape(width, 1)
    grads["b_alpha"] = small[layers * width + width :]
    return grads


def backbone_x_columns(cfg: NerfMLPConfig) -> List[List[int]]:
    """For each layer, the X column blocks (`backbone_scratch_shapes`) that
    feed its rows of the padded weight gradient, 64 rows each, in order: the
    encoding (block 0) for layer 0; layer i's input, layer i - 1's
    activation (blocks 1 + (i - 1) W/64 + j), then at the skip layer the
    encoding again. The weight-gradient kernel pairs them into 128-row
    output tiles within each layer."""
    nb = cfg.layers_width // _BLOCK
    columns = []
    for i in range(cfg.backbone_layers_count):
        if i == 0:
            columns.append([0])
        else:
            columns.append([1 + (i - 1) * nb + j for j in range(nb)] + ([0] if i == cfg.skip_layer_idx else []))
    return columns


def backbone_grid(n: int, sm_count: int) -> int:
    """CTAs of the persistent kernels (the forward and the backward's
    per-tile kernel) for n points on a card of `sm_count` SMs: one per SM,
    at most one per 128-point tile."""
    return min(-(-n // _BACKBONE_TILE), sm_count)


def backbone_scratch_shapes(cfg: NerfMLPConfig, n: int, sm_count: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the backward's scratch for n points on a card of
    `sm_count` SMs: x (bf16 X blocks), g (bf16 G blocks), tile_part (f32
    column sums, one row per warpgroup of the per-tile kernel's
    `backbone_grid` CTAs), partial (f32 weight-gradient slabs, one per
    point chunk of the dW product, as many chunks as fill the SMs once).
    X[p, c] and G[p, c] hold points 64 p .. 64 p + 63 of feature columns
    64 c .. 64 c + 63 as a 64 x 64 block in `swizzled` order."""
    width, layers = cfg.layers_width, cfg.backbone_layers_count
    point_blocks = 2 * -(-n // _BACKBONE_TILE)
    dw_tiles = sum(-(-len(c) // 2) for c in backbone_x_columns(cfg))
    chunks = max(1, min(point_blocks, sm_count // dw_tiles))
    nb = width // _BLOCK
    return {
        "x": (point_blocks, 1 + (layers - 1) * nb, _BLOCK, _BLOCK),
        "g": (point_blocks, layers * nb, _BLOCK, _BLOCK),
        "tile_part": (2 * backbone_grid(n, sm_count), layers * width + width + 1),
        "partial": (chunks, _backbone_grad_rows(cfg), width),
    }


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _backbone_bwd(cfg, packed, encoded, g_h, g_alpha, buffers, ms):
    """Launches the backward kernels on the bf16 rounding of `encoded`, all
    they read of it; `ms`, a ctypes array of 3 floats or None, receives the
    three kernels' times (the call then waits for them)."""
    _backbone_kernel_checks(cfg, encoded, [g_h, g_alpha] + list(packed.values()))
    n, pe = encoded.shape
    width, layers, skip = cfg.layers_width, cfg.backbone_layers_count, _kernel_skip(cfg)
    device = encoded.device
    weights, biases = buffers if buffers is not None else backbone_buffers(cfg, packed)
    encoded = encoded.to(torch.bfloat16).contiguous()
    g_h, g_alpha = g_h.contiguous(), g_alpha.contiguous()
    d_encoded = torch.empty((n, pe), dtype=torch.float32, device=device)
    grads_out = torch.empty((_backbone_grad_rows(cfg) * width + layers * width + width + 1,),
                            dtype=torch.float32, device=device)
    if n == 0:
        return _unpack_backbone_grads(cfg, grads_out.zero_(), pe), d_encoded
    shapes = backbone_scratch_shapes(cfg, n, _sm_count(device))
    scratch = {k: torch.empty(v, dtype=torch.bfloat16 if k in ("x", "g") else torch.float32, device=device)
               for k, v in shapes.items()}
    err = _backbone_library().fused_backbone_bwd_launch(
        encoded.data_ptr(), g_h.data_ptr(), g_alpha.data_ptr(), weights.data_ptr(), biases.data_ptr(),
        d_encoded.data_ptr(), *(scratch[k].data_ptr() for k in ("x", "g", "tile_part", "partial")),
        grads_out.data_ptr(), n, pe, width, layers, skip, shapes["tile_part"][0] // 2, shapes["partial"][0],
        torch.cuda.current_stream(device).cuda_stream, ms,
    )
    if err != 0:
        raise RuntimeError(f"fused_backbone_bwd kernel launch failed with CUDA error {err}")
    return _unpack_backbone_grads(cfg, grads_out, pe), d_encoded


def fused_backbone_bwd(
    cfg: NerfMLPConfig,
    packed: Dict[str, torch.Tensor],
    encoded: torch.Tensor,
    g_h: torch.Tensor,
    g_alpha: torch.Tensor,
    buffers=None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The backbone's backward: ({name: gradient}, (N, E) f32 d_encoded) for
    the cotangents g_h (N, W) and g_alpha (N,). On the card the kernels
    read only the bf16 rounding of `encoded` (f32 or bf16, as the autograd
    Function saves it).

    CPU tensors take `plain_backbone_bwd`. CUDA tensors launch the backward
    kernels (one call counted in `fused_backbone_bwd.launches`) on
    `buffers` as in `fused_backbone_fwd`; the gradients are bit-identical
    from run to run on one card.
    """
    if encoded.device.type == "cpu":
        return plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
    out = _backbone_bwd(cfg, packed, encoded, g_h, g_alpha, buffers, None)
    if encoded.shape[0]:
        fused_backbone_bwd.launches += 1
    return out


fused_backbone_bwd.launches = 0


def backbone_bwd_breakdown(cfg, packed, encoded, g_h, g_alpha) -> Dict[str, float]:
    """One backward on the card, timed by CUDA events around its three
    kernels (a measurement entry, not counted in the launches): ms of the
    per-tile kernel, the weight-gradient GEMM and the reduction."""
    ms = (ctypes.c_float * 3)()
    _backbone_bwd(cfg, packed, encoded, g_h, g_alpha, None, ms)
    return {"tile_ms": ms[0], "dw_ms": ms[1], "reduce_ms": ms[2]}


class _FusedBackbone(torch.autograd.Function):
    """Forward: fused_backbone_fwd; backward: fused_backbone_bwd on the saved
    (encoded, weights), as the JAX custom VJP saves (packed, encoded). On
    the card the forward's weight image is built once and kept for the
    backward, and the encodings are kept as their bf16 rounding, all the
    kernels read of them (half the memory of the f32 encodings)."""

    @staticmethod
    def forward(ctx, cfg, encoded, *tensors):
        packed = dict(zip(_backbone_names(cfg), tensors))
        ctx.cfg = cfg
        if encoded.device.type == "cpu":
            ctx.buffers = None
            ctx.save_for_backward(encoded, *tensors)
        else:
            ctx.buffers = backbone_buffers(cfg, packed)
            ctx.save_for_backward(encoded.to(torch.bfloat16), *tensors)
        return fused_backbone_fwd(cfg, packed, encoded, ctx.buffers)

    @staticmethod
    def backward(ctx, g_h, g_alpha):
        encoded, *tensors = ctx.saved_tensors
        names = _backbone_names(ctx.cfg)
        packed = dict(zip(names, tensors))
        if g_h is None:
            g_h = torch.zeros(encoded.shape[0], ctx.cfg.layers_width, device=encoded.device)
        if g_alpha is None:
            g_alpha = torch.zeros(encoded.shape[0], device=encoded.device)
        grads, d_encoded = fused_backbone_bwd(ctx.cfg, packed, encoded, g_h, g_alpha, ctx.buffers)
        ctx.buffers = None
        return (None, d_encoded) + tuple(grads[k].reshape(packed[k].shape) for k in names)


def fused_backbone(
    cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused backbone + alpha head over already-encoded points, differentiable
    in `packed` ({w0..wL-1, b0..bL-1, w_alpha, b_alpha}) and `encoded`
    ((N, E) f32), with both directions in kernels on the card.

    :return: ((N, layers_width) final activation, (N,) raw alpha).
    """
    names = _backbone_names(cfg)
    return _FusedBackbone.apply(cfg, encoded, *(packed[k] for k in names))
