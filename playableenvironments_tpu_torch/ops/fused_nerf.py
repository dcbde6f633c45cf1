"""The AdaIN-NeRF MLP's hand-written CUDA kernels.

Port of playableenvironments_tpu/ops/fused_nerf.py:
- the inference half, `fused_adain_nerf`: the per-point pipeline 8x256
  backbone with mid skip -> alpha head + AdaIN-modulated feature head, over
  pre-encoded points, with eval-mode BN statistics folded into a per-ray
  scale/bias (csrc/fused_nerf.cu). `fused_adain_nerf_group` runs several
  objects of one MLP configuration in one launch; `fused_adain_nerf` keeps
  the JAX function's per-object interface as a group of one;
- the trainable backbone, `fused_backbone`: backbone + alpha head as a
  torch.autograd.Function whose forward (`fused_backbone_fwd`) and backward
  (`fused_backbone_bwd`) are kernels: csrc/fused_backbone.cu for bf16
  operands, csrc/fused_backbone_f32.cu (`backbone_f32_fwd`,
  `backbone_f32_bwd`) for an f32 `compute_dtype`.
All are sm_90a tensor-core kernels with f32 accumulation that share
csrc/nerf_wgmma.cuh; the f32 ones split each f32 operand into two TF32
halves and run three TF32 products a multiply-add (3xTF32). All are built
with nvcc at first use and loaded with ctypes.

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
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from playableenvironments_tpu_torch.config import NerfMLPConfig
from playableenvironments_tpu_torch.core.bbox import aabb_contains, aabb_size
from playableenvironments_tpu_torch.models.encoding import positional_encoding

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "fused_nerf.cu"
_BACKBONE_SOURCE = _CSRC / "fused_backbone.cu"
_BACKBONE_F32_SOURCE = _CSRC / "fused_backbone_f32.cu"
_ROLLOUT_SOURCE = _CSRC / "fused_rollout.cu"  # B4/B5, wrapped in ops/fused_rollout.py
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# Limits of the B1 kernel's layout (csrc/fused_nerf.cu): the widths whose
# feature-head slots it takes, the encoding columns and outputs it pads to,
# the objects of one launch.
_ADAIN_WIDTHS = (128, 256)
_MAX_PE = 64
_MAX_OUT = 256
_ADAIN_MAX_OBJECTS = 16
_MAX_WIDTH = 256  # the backbone kernels' widest layer (csrc/fused_backbone.cu)


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


@dataclass(frozen=True)
class NerfKernelWeights:
    """One object's MLP weights: `packed` in the JAX layout (what the plain
    version reads), the kernel's bf16 weight image (`adain_image`; None for
    a width the kernel does not take, which then runs only on the CPU) and
    its f32 biases b_0 .. b_{L-1}, b_alpha, b_out."""

    packed: Dict[str, torch.Tensor]
    image: Optional[torch.Tensor]
    biases: torch.Tensor
    pe: int


def _swizzled_blocks(w: torch.Tensor) -> torch.Tensor:
    """(64 a, 64 b) -> a x b unswizzled 64 x 64 blocks, slot-major: block
    (i, j) holds rows 64 i .. and columns 64 j .. of `w`."""
    rows, cols = w.shape
    return w.reshape(rows // _BLOCK, _BLOCK, cols // _BLOCK, _BLOCK).permute(0, 2, 1, 3).reshape(-1, _BLOCK * _BLOCK)


def adain_image(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """B1's bf16 weight image as csrc/fused_nerf.cu reads it: the backbone
    image of `backbone_buffers` (slots, then w_alpha), then the feature
    head's 64-row slots, each its 64 x 64 blocks in wgmma's 128-byte
    swizzle: W_f0's columns [0, W / 2), its columns [W / 2, W) (the kernel
    runs f0 in two passes), W_f1 (W, W / 2), W_out (W / 2, outputs rounded
    up to 64, zero-padded), built on the weights' device by gathers.
    Raises for a configuration the kernel does not take."""
    width, pe, out = cfg.layers_width, packed["w0"].shape[0], packed["w_out"].shape[1]
    if width not in _ADAIN_WIDTHS:
        raise ValueError(f"layers_width {width}: the AdaIN-NeRF kernel takes {_ADAIN_WIDTHS}")
    if pe > _MAX_PE:
        raise ValueError(f"encoding width {pe} exceeds the kernel's {_MAX_PE}")
    if out > _MAX_OUT:
        raise ValueError(f"output_features {out} exceeds the kernel's {_MAX_OUT}")
    if cfg.skip_layer_idx == 0:
        raise ValueError("skip_layer_idx 0 (skip into the first layer) is not supported")
    half = width // 2
    with torch.no_grad():
        backbone, _ = backbone_buffers(cfg, packed)
        mats = [packed["w_f0"][:, :half], packed["w_f0"][:, half:], packed["w_f1"],
                _padded(packed["w_out"], half, -(-out // _BLOCK) * _BLOCK)]
        blocks = torch.cat([_swizzled_blocks(m.to(torch.bfloat16)) for m in mats])
        head = blocks[:, _unswizzle(blocks.device)]
        return torch.cat([backbone, head.reshape(-1)])


def _padded(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """`w` in the top-left corner of a (rows, cols) zero matrix."""
    z = w.new_zeros((rows, cols))
    z[: w.shape[0], : w.shape[1]] = w
    return z


def kernel_weights(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> NerfKernelWeights:
    """Build the kernel's buffers from `packed` once (on the weights'
    device): the image for the widths the kernel takes (raising for an
    encoding, output count or skip it does not take), the biases always."""
    pe = packed["w0"].shape[0]
    with torch.no_grad():
        image = adain_image(cfg, packed) if cfg.layers_width in _ADAIN_WIDTHS else None
        biases = torch.cat(
            [packed[f"b{i}"] for i in range(cfg.backbone_layers_count)] + [packed["b_alpha"], packed["b_out"]]
        ).to(torch.float32).contiguous()
    return NerfKernelWeights(packed={k: v.detach() for k, v in packed.items()}, image=image, biases=biases, pe=pe)


def adain_pair_table(n_points: Sequence[int], ctas: int = 2) -> List[int]:
    """The pair prefix table of one grouped launch: object o's pairs (units
    of `ctas` 128-point tiles, one tile per CTA of a cluster) are
    [table[o], table[o + 1]); a pair never holds two objects' points."""
    table = [0]
    for n in n_points:
        tiles = -(-n // _BACKBONE_TILE)
        table.append(table[-1] + -(-tiles // ctas))
    return table


def _included_headers(source: Path) -> List[Path]:
    """The csrc/*.cuh files `source` includes (#include "x.cuh"), looked up
    beside it, then in csrc/."""
    headers = []
    for line in source.read_text().splitlines():
        parts = line.split('"')
        if line.startswith("#include") and len(parts) == 3 and parts[1].endswith(".cuh"):
            header = source.with_name(parts[1])
            headers.append(header if header.exists() else _CSRC / parts[1])
    return headers


def _library_path(source: Path, defines: Tuple[str, ...] = ()) -> Path:
    """The library built from `source` with `defines`, named by a digest of
    the source, every header it includes and the defines."""
    digest = hashlib.sha1(source.read_bytes())
    for header in _included_headers(source):
        digest.update(header.read_bytes())
    for define in defines:
        digest.update(define.encode())
    return _BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:12]}.so"


def build_kernels(sources: Tuple[Path, ...] = (_SOURCE, _BACKBONE_SOURCE, _BACKBONE_F32_SOURCE, _ROLLOUT_SOURCE),
                  defines: Tuple[str, ...] = ()) -> Dict[str, str]:
    """Compile each CUDA source with nvcc for sm_90a into the build
    directory, once per content (the source, its headers from csrc/ and the
    `defines`, each NAME=VALUE); the nvcc processes run together.

    :return: {source name: nvcc's report (registers, shared memory, spills)},
        "" for a library that was already built.
    """
    todo = [s for s in sources if not _library_path(s, defines).exists()]
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
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(_CSRC),
            *(f"-D{d}" for d in defines), "-o", tmp, str(source),
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
            os.replace(tmp, _library_path(source, defines))
            reports[source.name] = output
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def _load(source: Path, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    build_kernels((source,), defines)
    return ctypes.CDLL(str(_library_path(source, defines)))


def adain_library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """csrc/fused_nerf.cu built with `defines` and loaded, its functions
    typed (the port's own build has none; scripts/ablate_adain_nerf.py
    loads variants)."""
    lib = _load(_SOURCE, defines)
    lib.fused_adain_nerf_group_launch.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.fused_adain_nerf_group_launch.restype = ctypes.c_int
    lib.fused_adain_nerf_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_adain_nerf_max_clusters.restype = ctypes.c_int
    lib.fused_adain_nerf_cluster_size.argtypes = []
    lib.fused_adain_nerf_cluster_size.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built B1 kernel library, loaded once per process. Reached only
    when a CUDA tensor reaches the kernel."""
    return adain_library()


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


@functools.lru_cache(maxsize=None)
def _backbone_f32_library() -> ctypes.CDLL:
    """csrc/fused_backbone_f32.cu, built and loaded once per process."""
    lib = _load(_BACKBONE_F32_SOURCE)
    lib.backbone_f32_pack_launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 5
                                             + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.backbone_f32_fwd_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.backbone_f32_bwd_launch.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
                                            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)])
    for fn in (lib.backbone_f32_pack_launch, lib.backbone_f32_fwd_launch, lib.backbone_f32_bwd_launch):
        fn.restype = ctypes.c_int
    return lib


class AdaInNerfItem(NamedTuple):
    """One object of a grouped launch: its weights, (N, pe) encodings, per-ray
    modulation (N / samples_per_ray rows; scale0/bias0 W columns,
    scale1/bias1 W // 2) and samples per ray (N = rays * samples_per_ray,
    ray-major)."""

    weights: NerfKernelWeights
    encoded: torch.Tensor
    scale0: torch.Tensor
    bias0: torch.Tensor
    scale1: torch.Tensor
    bias1: torch.Tensor
    samples_per_ray: int = 1


def _check_item(cfg: NerfMLPConfig, item: AdaInNerfItem) -> None:
    n, pe = item.encoded.shape
    width, samples = cfg.layers_width, item.samples_per_ray
    if samples < 1 or n % samples:
        raise ValueError(f"point count {n} not divisible by samples {samples}")
    rays = n // samples
    for name, cols in (("scale0", width), ("bias0", width), ("scale1", width // 2), ("bias1", width // 2)):
        t = getattr(item, name)
        if tuple(t.shape) != (rays, cols):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(rays, cols)}")
    if pe != item.weights.pe:
        raise ValueError(f"encoding width {pe} != the weights' {item.weights.pe}")


def fused_adain_nerf_group(cfg: NerfMLPConfig, items: Sequence[AdaInNerfItem]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The MLP over several objects of one configuration, each with its own
    weights, encodings and modulation: [((N, output_features) f32 features,
    (N,) f32 raw alpha)] in the order of `items`.

    CPU tensors take `plain_adain_nerf` object by object. CUDA tensors run
    one kernel launch for up to 16 objects (objects without points take
    none), walking the pair table of `adain_pair_table`; each launch adds 1
    to `fused_adain_nerf.launches` and its objects to
    `fused_adain_nerf.objects`. Any other device, a width the kernel does not
    take, or a failed build or launch raises.
    """
    for item in items:
        _check_item(cfg, item)
    if not items:
        return []
    device = items[0].encoded.device
    if device.type == "cpu":
        return [plain_adain_nerf(cfg, it.weights.packed, it.encoded, it.scale0, it.bias0, it.scale1, it.bias1,
                                 it.samples_per_ray) for it in items]
    if device.type != "cuda":
        raise ValueError(f"fused_adain_nerf runs on cuda or cpu tensors, not {device}")
    if cfg.layers_width not in _ADAIN_WIDTHS or any(it.weights.image is None for it in items):
        raise ValueError(f"layers_width {cfg.layers_width}: the AdaIN-NeRF kernel takes {_ADAIN_WIDTHS}")

    out_features = items[0].weights.packed["w_out"].shape[1]
    for it in items:
        for t in (it.encoded, it.scale0, it.bias0, it.scale1, it.bias1, it.weights.image, it.weights.biases):
            if t.device != device:
                raise ValueError(f"all inputs must be on {device}, got one on {t.device}")
        for t in (it.scale0, it.bias0, it.scale1, it.bias1):
            if t.dtype != torch.float32:
                raise ValueError(f"modulation must be float32, got {t.dtype}")
        if it.weights.packed["w_out"].shape[1] != out_features:
            raise ValueError("the objects of one group must have the same output_features")
    # One allocation per output for the whole group, split into views.
    counts = [it.encoded.shape[0] for it in items]
    features = torch.empty((sum(counts), out_features), dtype=torch.float32, device=device).split(counts)
    alphas = torch.empty((sum(counts),), dtype=torch.float32, device=device).split(counts)
    # Objects with points; the kernel reads modulation rows with their stride
    # (fold_adain_stats' scale and bias are column halves of one array), in
    # aligned pairs of floats.
    launch = [i for i, n in enumerate(counts) if n]
    lib = _library()
    ctas = lib.fused_adain_nerf_cluster_size()
    stream = torch.cuda.current_stream(device).cuda_stream
    for first in range(0, len(launch), _ADAIN_MAX_OBJECTS):
        chunk = launch[first : first + _ADAIN_MAX_OBJECTS]
        ptrs, ints, keep = [], [], []  # keep: the temporaries stay alive until the launch is enqueued
        for i in chunk:
            it = items[i]
            encoded = it.encoded.to(torch.bfloat16).contiguous()
            keep.append(encoded)
            ptrs.append(encoded.data_ptr())
            ints += [counts[i], it.samples_per_ray]
            for t in (it.scale0, it.bias0, it.scale1, it.bias1):
                stride, ptr = t.stride(), t.data_ptr()
                if stride[1] != 1 or stride[0] % 2 or ptr % 8:
                    t = t.contiguous()
                    keep.append(t)
                    stride, ptr = t.stride(), t.data_ptr()
                ptrs.append(ptr)
                ints.append(stride[0])
            ptrs += [it.weights.image.data_ptr(), it.weights.biases.data_ptr(), features[i].data_ptr(),
                     alphas[i].data_ptr()]
        table = adain_pair_table([counts[i] for i in chunk], ctas)
        err = lib.fused_adain_nerf_group_launch(
            len(chunk), (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_int * len(table))(*table), items[0].weights.pe, cfg.layers_width,
            cfg.backbone_layers_count, cfg.skip_layer_idx, out_features, stream,
        )
        if err != 0:
            raise RuntimeError(f"fused_adain_nerf kernel launch failed with CUDA error {err}")
        fused_adain_nerf.launches += 1
        fused_adain_nerf.objects += len(chunk)
    return list(zip(features, alphas))


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
    """The MLP over one object's pre-encoded points, ray-major (N = rays *
    samples_per_ray): `fused_adain_nerf_group` of one item.

    :param encoded: (N, pe) encodings (rounded to bf16 on the card).
    :param scale0/bias0: (N / samples_per_ray, W) f32 per-ray modulation;
        scale1/bias1 (N / samples_per_ray, W // 2).
    :return: ((N, output_features) f32 features, (N,) f32 raw alpha).
    """
    item = AdaInNerfItem(weights, encoded, scale0, bias0, scale1, bias1, samples_per_ray)
    return fused_adain_nerf_group(cfg, [item])[0]


fused_adain_nerf.launches = 0
fused_adain_nerf.objects = 0


class ObjectField(NamedTuple):
    """One object's eval-mode field query for `fused_object_field_eval_group`:
    its bounding box, models.nerf.AdaInNerfMLP, (..., rays, samples, 3)
    object-frame points, (..., rays, 1, style_features) style (constant
    along each ray) and the alpha of empty space."""

    bounding_box: object
    nerf: object
    positions: torch.Tensor
    style: torch.Tensor
    empty_space_alpha: float


def fused_object_field_eval_group(
    cfg: NerfMLPConfig, fields: Sequence[ObjectField]
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Eval-mode object fields of one NeRF configuration through one grouped
    MLP call: bbox mask, bbox normalization, positional encoding and the
    AdaIN fold here per object, the MLP in the kernel, empty-space masking
    after.

    :return: per field, ((..., rays, samples, F) features, (..., rays,
        samples) raw alphas).
    """
    items, masks = [], []
    for f in fields:
        positions = f.positions
        box = torch.as_tensor(f.bounding_box, dtype=positions.dtype, device=positions.device)
        masks.append(aabb_contains(box, positions))
        ray_shape = positions.shape[:-2]
        style_rays = f.style[..., 0, :].expand(ray_shape + f.style.shape[-1:])
        flat_style = style_rays.reshape(-1, f.style.shape[-1])
        pe_cfg = cfg.position_encoder
        encoded = positional_encoding(positions.reshape(-1, 3) / aabb_size(box), pe_cfg.octaves,
                                      pe_cfg.append_original)
        scale0, bias0 = fold_adain_stats(f.nerf.adain_0, flat_style)
        scale1, bias1 = fold_adain_stats(f.nerf.adain_1, flat_style)
        items.append(AdaInNerfItem(f.nerf.kernel_weights(), encoded, scale0, bias0, scale1, bias1,
                                   positions.shape[-2]))

    results = []
    for f, mask, (features, alpha) in zip(fields, masks, fused_adain_nerf_group(cfg, items)):
        batch_shape = f.positions.shape[:-1]
        features = features.reshape(batch_shape + (features.shape[-1],))
        alpha = alpha.reshape(batch_shape)
        results.append((torch.where(mask[..., None], features, 0.0),
                        torch.where(mask, alpha, float(f.empty_space_alpha))))
    return results


def fused_object_field_eval(
    cfg: NerfMLPConfig,
    bounding_box,
    nerf,
    positions: torch.Tensor,
    style: torch.Tensor,
    empty_space_alpha: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One object's eval-mode field through the fused MLP
    (`fused_object_field_eval_group` of one field).

    :param nerf: models.nerf.AdaInNerfMLP.
    :param positions: (..., rays, samples, 3) object-frame points.
    :param style: (..., rays, 1, style_features), constant along each ray.
    :return: ((..., rays, samples, F) features, (..., rays, samples) raw alphas).
    """
    field = ObjectField(bounding_box, nerf, positions, style, empty_space_alpha)
    return fused_object_field_eval_group(cfg, [field])[0]


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
    masks: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The TPU backward kernel's explicit backward in plain PyTorch (not
    autograd): recompute the activations, back-propagate through the ReLU
    chain, split the skip layer's input gradient.

    :param g_h: (N, W) cotangent of h; :param g_alpha: (N,) of alpha.
    :param masks: each layer's (N, W) ReLU pattern to take the derivative
        at; by default the recomputed activations' own (> 0).
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
        g = g * (acts[i] > 0.0 if masks is None else masks[i])
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


def relu_pattern_check(
    cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor, layer_outputs
) -> Tuple[List[torch.Tensor], List[Dict[str, float]]]:
    """Holds each layer's post-ReLU output, as some implementation computes
    it, against the f64 forward (its own ReLUs, f64 products and sums).

    Each unit's pre-activation z is measured in units of its rounding scale
    s = sum_k |x_k w_kj| + |b_j| (f64 inputs x): an implementation with f32
    sums is off by a few f32 ulps of s, and takes a ReLU on the other side
    of f64's only where |z| lies within that.

    :param layer_outputs: an iterable of the (N, W) outputs of layers 0, 1,
        ..., consumed one at a time (a generator keeps one on the card).
    :return: (each layer's ReLU pattern, output > 0; for each layer
        {"flips": units whose pattern differs from f64's, "flip_ratio": the
        largest |z| / s among them (0 without one), "error_ratio": the
        largest |output - z| / s where both are positive}).
    """
    p = {k: v.double() for k, v in packed.items()}
    enc = encoded.double()
    h, masks, rows = enc, [], []
    for i, out in zip(range(cfg.backbone_layers_count), layer_outputs):
        if i == cfg.skip_layer_idx and i != 0:
            h = torch.cat([h, enc], dim=-1)
        scale = h.abs() @ p[f"w{i}"].abs() + p[f"b{i}"].abs()
        z = h @ p[f"w{i}"] + p[f"b{i}"]
        mask = out > 0
        positive = z > 0
        flipped = mask != positive
        both = mask & positive
        rows.append({
            "flips": int(flipped.sum()),
            "flip_ratio": (z.abs() / scale)[flipped].max().item() if bool(flipped.any()) else 0.0,
            "error_ratio": ((out.double() - z).abs() / scale)[both].max().item() if bool(both.any()) else 0.0,
        })
        masks.append(mask)
        h = torch.relu(z)
        del scale, z, positive, flipped, both, out
    return masks, rows


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
    """The backbone's weights as csrc/fused_backbone.cu (and B1, which
    shares its backbone) reads them, whatever the configuration's
    `compute_dtype`: the bf16 weight image (every layer's 64-row slots,
    each W/64 swizzled 64 x 64 blocks, then w_alpha) and the f32 biases
    b_0 .. b_{L-1}, b_alpha. A handful of small kernels a launch: the
    slots' rows in one cat, one cast, one gather for the swizzle."""
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
    the card of `encoded`. The kernels follow `compute_dtype`: bfloat16
    operands (csrc/fused_backbone.cu, widths multiple of 64 up to 256) or
    float32 (csrc/fused_backbone_f32.cu, widths 64, 128 and 256)."""
    if encoded.device.type != "cuda":
        raise ValueError(f"the fused backbone runs on cuda or cpu tensors, not {encoded.device}")
    width = cfg.layers_width
    if cfg.compute_dtype == "float32":
        if width not in _F32_WIDTHS:
            raise ValueError(f"layers_width {width}: the f32 backbone kernels take widths {_F32_WIDTHS}")
    elif cfg.compute_dtype != "bfloat16":
        raise NotImplementedError(
            f"the backbone kernels take bfloat16 or float32 operands, not compute_dtype {cfg.compute_dtype!r}"
        )
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
    if cfg.compute_dtype == "float32":
        return backbone_f32_fwd(cfg, packed, encoded, buffers)
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
    if cfg.compute_dtype == "float32":
        return backbone_f32_bwd(cfg, packed, encoded, g_h, g_alpha, buffers)
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


# ---- the f32 backbone kernels (csrc/fused_backbone_f32.cu) -------------------

# Widths the f32 kernels take, points a tile, and tiles of points the
# backward walks at a time (its X and G scratch hold one chunk).
_F32_WIDTHS = (64, 128, 256)
_F32_TILE = 64
_F32_CHUNK_TILES = 1024
_F32_BLOCK_POINTS = 32  # points of a scratch block: one 128-byte feature row


class F32Buffers(NamedTuple):
    """The f32 kernels' weights (csrc/fused_backbone_f32.cu): the `fwd` and
    `bwd` 3xTF32 images (2 x rows_pad x W floats each), the biases b_0 ..
    b_{L-1}, b_alpha and w_alpha (W), f32."""

    fwd: torch.Tensor
    bwd: torch.Tensor
    biases: torch.Tensor
    w_alpha: torch.Tensor


def backbone_f32_weights(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """Each layer's weight as the f32 kernels pad it, (rows_i, W): the
    encoding's rows zero-padded to 64 (layer 0, and after the activation
    rows at the skip layer), the rows of `_backbone_grad_rows`' order."""
    width, skip = cfg.layers_width, cfg.skip_layer_idx
    out = []
    for i in range(cfg.backbone_layers_count):
        w = packed[f"w{i}"].to(torch.float32)
        if i == 0:
            out.append(torch.nn.functional.pad(w, (0, 0, 0, _BACKBONE_PE - w.shape[0])))
        elif i == skip:
            enc = w[width:]
            out.append(torch.cat([w[:width], torch.nn.functional.pad(enc, (0, 0, 0, _BACKBONE_PE - enc.shape[0]))]))
        else:
            out.append(w)
    return out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 `x` rounded to TF32 (10 mantissa bits; nearest, ties away from
    zero: PTX's cvt.rna.tf32.f32), kept in f32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = big + small as the f32 kernels split an operand: big = x rounded
    to TF32, small = the rest rounded the same way."""
    big = tf32_round(x)
    return big, tf32_round(x.to(torch.float32) - big)


def f32_fragment_offset(n, k):
    """Float offset of (n, k) in one half of a slot: wgmma's K-major layout
    without swizzle, core matrices of 8 n x 4 k floats (128 bytes), the two
    of a k-step 32 floats apart, groups of 8 n 64 floats apart."""
    return (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4


def _logical_k(m):
    """The logical k that reads physical row m of a k-step: the kernels take
    the 8 K rows of a k-step in the order pi(k) = 2 (k % 4) + k / 4, so that
    an accumulator fragment is the next product's A fragment."""
    return (m // 2) + 4 * (m % 2)


def plain_backbone_f32_buffers(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> F32Buffers:
    """The f32 kernels' weights built in plain PyTorch, the plain version of
    csrc/fused_backbone_f32.cu::backbone_f32_pack_kernel, bit for bit. Layer
    i starts at float 2 W (padded rows before it) in both images:
    - fwd: its in_i / 8 slots (k-steps of its padded input rows, taken in
      `_logical_k`'s order), each big then small of (n = W output
      columns) x 8 at `f32_fragment_offset`;
    - bwd: W / 8 slots of its 64 encoding rows as n (layer 0, and first at
      the skip layer), then (layers > 0) W / 8 slots of its W activation
      rows, k over the output columns in the same order."""
    width, skip = cfg.layers_width, _kernel_skip(cfg)
    device = packed["w0"].device
    fwd, bwd = [], []
    with torch.no_grad():
        for i, w in enumerate(backbone_f32_weights(cfg, packed)):
            rows = w.shape[0]
            big, small = tf32_split(w)
            rr, c = torch.meshgrid(torch.arange(rows, device=device), torch.arange(width, device=device), indexing="ij")
            f = torch.empty(2 * rows * width, dtype=torch.float32, device=device)
            dst = (rr // 8) * 16 * width + f32_fragment_offset(c, _logical_k(rr % 8))
            f[dst] = big
            f[dst + 8 * width] = small
            b = torch.empty_like(f)
            n_rows = torch.full_like(rr, width)
            nn, base = rr.clone(), torch.zeros_like(rr)
            if i == 0:
                n_rows[:] = _BACKBONE_PE
            elif i == skip:
                enc = rr >= width
                n_rows[enc] = _BACKBONE_PE
                nn[enc] -= width
                base[~enc] = (width // 8) * 16 * _BACKBONE_PE
            dst = base + (c // 8) * 16 * n_rows + f32_fragment_offset(nn, _logical_k(c % 8))
            b[dst] = big
            b[dst + 8 * n_rows] = small
            fwd.append(f)
            bwd.append(b)
        biases = torch.cat([packed[f"b{i}"].reshape(-1) for i in range(cfg.backbone_layers_count)]
                           + [packed["b_alpha"].reshape(-1)]).to(torch.float32)
        w_alpha = packed["w_alpha"].reshape(-1).to(torch.float32)
    return F32Buffers(torch.cat(fwd), torch.cat(bwd), biases.contiguous(), w_alpha.contiguous())


def backbone_f32_buffers(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> F32Buffers:
    """The f32 kernels' weights (`F32Buffers`, layouts in
    `plain_backbone_f32_buffers`). CPU tensors take the plain version; on
    the card one launch of backbone_f32_pack_kernel builds them from the
    packed weights as they lie (strided views included), counted in
    `backbone_f32_buffers.launches`. Raises for what the kernels do not
    take."""
    device = packed["w0"].device
    if device.type == "cpu":
        return plain_backbone_f32_buffers(cfg, packed)
    width, layers, pe = cfg.layers_width, cfg.backbone_layers_count, packed["w0"].shape[0]
    _backbone_kernel_checks(cfg, packed["w0"].new_empty((0, pe)), list(packed.values()))
    rows = _backbone_grad_rows(cfg)
    fwd = torch.empty(2 * rows * width, dtype=torch.float32, device=device)
    bwd = torch.empty_like(fwd)
    biases = torch.empty(layers * width + 1, dtype=torch.float32, device=device)
    w_alpha = torch.empty(width, dtype=torch.float32, device=device)
    ws = [packed[f"w{i}"] for i in range(layers)]
    bs = [packed[f"b{i}"] for i in range(layers)]
    err = _backbone_f32_library().backbone_f32_pack_launch(
        (ctypes.c_void_p * layers)(*(w.data_ptr() for w in ws)),
        (ctypes.c_longlong * (2 * layers))(*(s for w in ws for s in w.stride())),
        (ctypes.c_void_p * layers)(*(b.data_ptr() for b in bs)),
        (ctypes.c_longlong * layers)(*(b.stride()[-1] for b in bs)),
        packed["w_alpha"].data_ptr(), packed["w_alpha"].stride()[0], packed["b_alpha"].data_ptr(),
        fwd.data_ptr(), bwd.data_ptr(), biases.data_ptr(), w_alpha.data_ptr(), width, layers, _kernel_skip(cfg), pe,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"backbone_f32_pack kernel launch failed with CUDA error {err}")
    backbone_f32_buffers.launches += 1
    return F32Buffers(fwd, bwd, biases, w_alpha)


backbone_f32_buffers.launches = 0


def backbone_f32_row_blocks(cfg: NerfMLPConfig) -> List[Tuple[int, int, int, int]]:
    """The f32 weight-gradient kernel's row blocks: (first padded row, X
    feature of its first 64 rows, of its second 64 rows or -1, layer). X
    holds the encoding (features 0-63), then the activations of layers 0 ..
    L-2 (W each); layer i reads its input's 64-feature halves in its padded
    row order (the encoding for layer 0; layer i - 1's activation, then the
    encoding at the skip layer), two a block."""
    width, layers, skip = cfg.layers_width, cfg.backbone_layers_count, _kernel_skip(cfg)
    table, out_row = [], 0
    for i in range(layers):
        if i == 0:
            halves = [0]
        else:
            halves = [_BACKBONE_PE + (i - 1) * width + _BLOCK * j for j in range(width // _BLOCK)]
            halves += [0] if i == skip else []
        for k in range(0, len(halves), 2):
            table.append((out_row + _BLOCK * k, halves[k], halves[k + 1] if k + 1 < len(halves) else -1, i))
        out_row += _BLOCK * len(halves)
    return table


def backbone_f32_dw_columns(cfg: NerfMLPConfig) -> int:
    """Output columns of one weight-gradient CTA: min(W, 128)."""
    return min(cfg.layers_width, 128)


def backbone_f32_scratch_shapes(cfg: NerfMLPConfig, n: int, sm_count: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the f32 backward's buffers for n points on a card of
    `sm_count` SMs. x and g: the X and G scratch of one chunk of points
    (`_F32_CHUNK_TILES` tiles of 64), feature-major in blocks of 32 points,
    X[b, f, swizzled(f, p % 32)] for point p = 32 b + p % 32 of the chunk,
    the 16-byte chunks of a feature's 128-byte row XOR-ed with f % 8 (X:
    the encoding, then the activations of layers 0 .. L-2; G: G_0 ..
    G_{L-1}). tile_part: the tile kernel's column sums, a row per warpgroup
    of its CTAs (as many as SMs, at most one per tile). partial: one
    weight-gradient slab per split of a chunk's points, as many splits as
    fill the SMs once. masks: each tile-kernel thread's ReLU mask bits
    (W / 4 of them in two words; int32 for u32), per CTA and layer."""
    width, layers = cfg.layers_width, cfg.backbone_layers_count
    chunk_tiles = min(-(-n // _F32_TILE), _F32_CHUNK_TILES)
    grid = min(chunk_tiles, sm_count)
    blocks = chunk_tiles * _F32_TILE // _F32_BLOCK_POINTS
    dw_ctas = len(backbone_f32_row_blocks(cfg)) * (width // backbone_f32_dw_columns(cfg))
    return {
        "x": (blocks, _BACKBONE_PE + (layers - 1) * width, _F32_BLOCK_POINTS),
        "g": (blocks, layers * width, _F32_BLOCK_POINTS),
        "tile_part": (2 * grid, layers * width + width + 1),
        "partial": (max(1, min(blocks, sm_count // dw_ctas)), _backbone_grad_rows(cfg), width),
        "masks": (grid, layers, 2, 256),
    }


@functools.lru_cache(maxsize=None)
def _row_block_table(layers: int, width: int, skip: int, device: torch.device) -> torch.Tensor:
    cfg = NerfMLPConfig(layers_width=width, backbone_layers_count=layers, skip_layer_idx=skip)
    return torch.tensor(backbone_f32_row_blocks(cfg), dtype=torch.int32).reshape(-1).to(device)


def backbone_f32_fwd(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor,
                     buffers: Optional[F32Buffers] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 forward kernel (B2 for f32 operands) on the card over (N, E)
    f32 encodings -> ((N, W) h, (N,) alpha), one launch counted in
    `backbone_f32_fwd.launches`; `buffers` as backbone_f32_buffers gives
    them, built here when not given. Raises for what it does not take."""
    _backbone_kernel_checks(cfg, encoded, [encoded] + list(packed.values()))
    n, pe = encoded.shape
    width = cfg.layers_width
    buffers = buffers if buffers is not None else backbone_f32_buffers(cfg, packed)
    encoded = encoded.contiguous()
    h = torch.empty((n, width), dtype=torch.float32, device=encoded.device)
    alpha = torch.empty((n,), dtype=torch.float32, device=encoded.device)
    if n == 0:
        return h, alpha
    err = _backbone_f32_library().backbone_f32_fwd_launch(
        encoded.data_ptr(), buffers.fwd.data_ptr(), buffers.biases.data_ptr(), buffers.w_alpha.data_ptr(),
        h.data_ptr(), alpha.data_ptr(), n, pe, width, cfg.backbone_layers_count, _kernel_skip(cfg),
        min(-(-n // _F32_TILE), _sm_count(encoded.device)), torch.cuda.current_stream(encoded.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"backbone_f32_fwd kernel launch failed with CUDA error {err}")
    backbone_f32_fwd.launches += 1
    return h, alpha


backbone_f32_fwd.launches = 0


def backbone_f32_layer_outputs(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor):
    """Yields the (N, W) post-ReLU output of layers 0, 1, ... as the f32
    kernels compute it: B2-f32 over the first i + 1 layers, whose slots,
    tiles and sums are B3-f32's recompute's. One launch a layer."""
    for i in range(cfg.backbone_layers_count):
        skip = cfg.skip_layer_idx if cfg.skip_layer_idx <= i else 0
        part = replace(cfg, backbone_layers_count=i + 1, skip_layer_idx=skip)
        yield backbone_f32_fwd(part, {k: packed[k] for k in _backbone_names(part)}, encoded)[0]


def _backbone_f32_bwd(cfg, packed, encoded, g_h, g_alpha, buffers, ms):
    """Launches the f32 backward kernels; `ms`, a ctypes array of 3 floats
    or None, receives the tile, weight-gradient and reduction kernels'
    milliseconds (the call then waits for each launch)."""
    _backbone_kernel_checks(cfg, encoded, [encoded, g_h, g_alpha] + list(packed.values()))
    n, pe = encoded.shape
    width, layers, skip = cfg.layers_width, cfg.backbone_layers_count, _kernel_skip(cfg)
    device = encoded.device
    buffers = buffers if buffers is not None else backbone_f32_buffers(cfg, packed)
    encoded, g_h, g_alpha = encoded.contiguous(), g_h.contiguous(), g_alpha.contiguous()
    d_encoded = torch.empty((n, pe), dtype=torch.float32, device=device)
    grads_out = torch.empty((_backbone_grad_rows(cfg) * width + layers * width + width + 1,),
                            dtype=torch.float32, device=device)
    if n == 0:
        return _unpack_backbone_grads(cfg, grads_out.zero_(), pe), d_encoded
    shapes = backbone_f32_scratch_shapes(cfg, n, _sm_count(device))
    scratch = {k: torch.empty(v, dtype=torch.int32 if k == "masks" else torch.float32, device=device)
               for k, v in shapes.items()}
    table = _row_block_table(layers, width, cfg.skip_layer_idx, device)
    err = _backbone_f32_library().backbone_f32_bwd_launch(
        encoded.data_ptr(), g_h.data_ptr(), g_alpha.data_ptr(), buffers.fwd.data_ptr(), buffers.bwd.data_ptr(),
        buffers.biases.data_ptr(), buffers.w_alpha.data_ptr(), d_encoded.data_ptr(),
        *(scratch[k].data_ptr() for k in ("x", "g", "tile_part", "partial", "masks")), table.data_ptr(),
        grads_out.data_ptr(), table.numel() // 4, n, pe, width, layers, skip, shapes["masks"][0],
        shapes["x"][0] * _F32_BLOCK_POINTS // _F32_TILE, shapes["partial"][0],
        torch.cuda.current_stream(device).cuda_stream, ms,
    )
    if err != 0:
        raise RuntimeError(f"backbone_f32_bwd kernel launch failed with CUDA error {err}")
    backbone_f32_bwd.launches += 1
    return _unpack_backbone_grads(cfg, grads_out, pe), d_encoded


def backbone_f32_bwd(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor,
                     g_h: torch.Tensor, g_alpha: torch.Tensor, buffers: Optional[F32Buffers] = None):
    """The f32 backward kernels (B3 for f32 operands) on the card: ({name:
    gradient}, (N, E) d_encoded), one call counted in
    `backbone_f32_bwd.launches`, bit-identical from run to run."""
    return _backbone_f32_bwd(cfg, packed, encoded, g_h, g_alpha, buffers, None)


backbone_f32_bwd.launches = 0


def backbone_f32_bwd_breakdown(cfg, packed, encoded, g_h, g_alpha, buffers=None) -> Dict[str, float]:
    """One f32 backward on the card, timed by CUDA events around each of
    its launches (counted in `backbone_f32_bwd.launches` as one call): ms
    of the tile kernels, the weight-gradient kernels and the reduction."""
    ms = (ctypes.c_float * 3)()
    _backbone_f32_bwd(cfg, packed, encoded, g_h, g_alpha, buffers, ms)
    return {"tile_ms": ms[0], "dw_ms": ms[1], "reduce_ms": ms[2]}


def kernel_buffers(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The weight buffers of the backbone kernels of `cfg`'s operand dtype:
    `backbone_f32_buffers` for float32, `backbone_buffers` for bf16."""
    if cfg.compute_dtype == "float32":
        return backbone_f32_buffers(cfg, packed)
    return backbone_buffers(cfg, packed)


def _runs_kernels(encoded: torch.Tensor) -> bool:
    """Whether the fused backbone launches its kernels for `encoded` (a
    tensor on the card) or runs its plain version (on the CPU)."""
    return encoded.device.type != "cpu"


def _saved_encoding(cfg: NerfMLPConfig, encoded: torch.Tensor) -> torch.Tensor:
    """What the autograd Function keeps of the encodings for the backward
    kernels: their bf16 rounding for bf16 operands (all B3 reads of them,
    half the memory), the f32 encodings themselves for f32 ones."""
    return encoded.to(torch.bfloat16) if cfg.compute_dtype == "bfloat16" else encoded


class _FusedBackbone(torch.autograd.Function):
    """Forward: fused_backbone_fwd; backward: fused_backbone_bwd on the saved
    (encoded, weights), as the JAX custom VJP saves (packed, encoded). On
    the card the forward's weight images are built once and kept for the
    backward, and the encodings as `_saved_encoding` keeps them."""

    @staticmethod
    def forward(ctx, cfg, encoded, *tensors):
        packed = dict(zip(_backbone_names(cfg), tensors))
        ctx.cfg = cfg
        if _runs_kernels(encoded):
            ctx.buffers = kernel_buffers(cfg, packed)
            ctx.save_for_backward(_saved_encoding(cfg, encoded), *tensors)
        else:
            ctx.buffers = None
            ctx.save_for_backward(encoded, *tensors)
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
