"""Serving exports: serialized, versioned render/dynamics artifacts.

Port of playableenvironments_tpu/serve.py with `torch.export` in place of
`jax.export`: the traced graph of a frame or dynamics function, with the
weights in its state (the modules it reads are submodules of the exported
wrapper), serves frames without the model code. Loading imports only this
module, the port's ops module (which registers B1 as the operator
`playableenvironments_torch::fused_adain_nerf_group` that the render graph
calls: the kernel on the card, its plain version on the CPU) and the
SceneEncoding dataclass.

Artifacts are single files, as the JAX package's: a 4-byte little-endian
header length, a JSON header (format version, name, platforms, the input
and output shapes `in_avals` / `out_avals` written as JAX writes them, e.g.
"float32[1,1,1,3]", and the argument and result structures), then the
`torch.export.save` bytes. A torch.export program runs on the device it
was traced on, so an artifact has exactly one platform, "cuda" or "cpu":
export once per target, from inputs and weights on that device.

Typical flow::

    from playableenvironments_tpu_torch import serve
    serve.export_renderer(renderer, encoding_example, "renderer.pexp", platforms=("cuda",))
    # ... on the serving host:
    render = serve.load_artifact("renderer.pexp")
    frames = render(encoding)          # (B, T, C, H, W, 3) in [0, 1]
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

# Registers the B1 operator that exported render graphs call.
from playableenvironments_tpu_torch.ops import fused_nerf
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding

FORMAT_VERSION = 1


def _wrap(serialized: bytes, header: dict) -> bytes:
    head = json.dumps({"format_version": FORMAT_VERSION, **header}).encode()
    return struct.pack("<I", len(head)) + head + serialized


def _unwrap(blob: bytes):
    (head_len,) = struct.unpack("<I", blob[:4])
    header = json.loads(blob[4 : 4 + head_len].decode())
    if header.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported artifact format {header.get('format_version')} "
            f"(this loader supports {FORMAT_VERSION})"
        )
    return header, blob[4 + head_len :]


def _flatten(tree: Any) -> Tuple[List[torch.Tensor], dict]:
    """(tensor leaves, a JSON structure) of tensors in tuples, lists, dicts
    and SceneEncodings; None kept as a leafless node."""
    if torch.is_tensor(tree):
        return [tree], {"t": "tensor"}
    if tree is None:
        return [], {"t": "none"}
    if isinstance(tree, SceneEncoding):
        children = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
        kind, keys = "SceneEncoding", None
    elif isinstance(tree, dict):
        keys = list(tree)
        children, kind = [tree[k] for k in keys], "dict"
    elif isinstance(tree, (tuple, list)):
        children, kind, keys = list(tree), type(tree).__name__, None
    else:
        raise TypeError(f"an exported function takes and returns tensors, not {type(tree).__name__}")
    leaves, specs = [], []
    for child in children:
        child_leaves, spec = _flatten(child)
        leaves += child_leaves
        specs.append(spec)
    node = {"t": kind, "items": specs}
    if keys is not None:
        node["keys"] = keys
    return leaves, node


def _unflatten(spec: dict, leaves) -> Any:
    """The structure of `spec` over an iterator of leaves."""
    kind = spec["t"]
    if kind == "tensor":
        return next(leaves)
    if kind == "none":
        return None
    children = [_unflatten(s, leaves) for s in spec["items"]]
    if kind == "SceneEncoding":
        return SceneEncoding(*children)
    if kind == "dict":
        return dict(zip(spec["keys"], children))
    return tuple(children) if kind == "tuple" else children


def _sequences_alike(spec: dict) -> dict:
    """`spec` with lists written as tuples: a call may pass either."""
    node = {**spec, "t": "tuple" if spec["t"] == "list" else spec["t"]}
    if "items" in spec:
        node["items"] = [_sequences_alike(s) for s in spec["items"]]
    return node


def _aval(t: torch.Tensor) -> str:
    """A tensor's shape as JAX writes an abstract value: float32[2,1,3]."""
    return f"{str(t.dtype).replace('torch.', '')}[{','.join(str(d) for d in t.shape)}]"


class _Call(nn.Module):
    """`fn` as the forward of a module that holds the modules it reads."""

    def __init__(self, fn: Callable, modules: Dict[str, nn.Module]):
        super().__init__()
        self.fn = fn
        for name, module in modules.items():
            self.add_module(name, module)

    def forward(self, *args):
        return self.fn(*args)


class _Exported(nn.Module):
    """The exported function over flat tensor leaves. The parameters and
    buffers of the modules it reads are this module's own, under their
    dotted names with "." written "__" (the graph's code names each, and a
    flax-named submodule such as the LSTM's `if` is no Python identifier),
    and are swapped into the modules for the call (torch.func.functional_call),
    so that torch.export lifts them into the program's state."""

    def __init__(self, fn: Callable, modules: Dict[str, nn.Module], in_spec: dict):
        super().__init__()
        self.in_spec = in_spec
        self._call = [_Call(fn, modules)]  # a list: not a submodule
        self._names = {}
        for name, tensor in self._call[0].state_dict(keep_vars=True).items():
            safe = name.replace(".", "__")
            self._names[name] = safe
            if isinstance(tensor, nn.Parameter):
                self.register_parameter(safe, tensor)
            else:
                self.register_buffer(safe, tensor)

    def forward(self, *leaves):
        state = {name: getattr(self, safe) for name, safe in self._names.items()}
        args = _unflatten(self.in_spec, iter(leaves))
        out, _ = _flatten(torch.func.functional_call(self._call[0], state, tuple(args)))
        return tuple(out)


def _platform(leaves: Sequence[torch.Tensor], modules: Dict[str, nn.Module]) -> str:
    devices = {t.device.type for t in leaves}
    for module in modules.values():
        devices |= {p.device.type for p in module.parameters()}
    if len(devices) != 1:
        raise ValueError(f"an exported function's inputs and weights lie on one device type, got {sorted(devices)}")
    return devices.pop()


def export_function(
    fn: Callable,
    example_args: Sequence,
    path: str,
    platforms: Sequence[str] = ("cpu",),
    name: str = "fn",
    modules: Optional[Dict[str, nn.Module]] = None,
) -> str:
    """Serialize the graph of `fn(*example_args)` (torch.export, shapes
    specialized to the example arguments) to `path`.

    :param modules: the nn.Modules `fn` reads, by name: their parameters and
        buffers become the program's state.
    :param platforms: the one device type of the example arguments and the
        modules, "cuda" or "cpu" (a torch.export program runs where it was
        traced); anything else raises.
    """
    modules = dict(modules or {})
    leaves, in_spec = _flatten(tuple(example_args))
    platform = _platform(leaves, modules)
    if list(platforms) != [platform]:
        raise ValueError(
            f"platforms {list(platforms)}: a torch.export artifact runs on the device type it was traced on "
            f"({platform}); export once per target, with the inputs and weights on it")
    with torch.no_grad():
        out_leaves, out_spec = _flatten(fn(*example_args))
        with fused_nerf.tracing():
            program = torch.export.export(_Exported(fn, modules, in_spec), tuple(leaves), strict=False)
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    blob = _wrap(buffer.getvalue(), {
        "name": name,
        "platforms": [platform],
        "in_avals": [_aval(t) for t in leaves],
        "out_avals": [_aval(t) for t in out_leaves],
        "in_tree": in_spec,
        "out_tree": out_spec,
    })
    with open(path, "wb") as f:
        f.write(blob)
    return path


class Artifact:
    """A loaded artifact: `header`, the `program` (torch.export's
    ExportedProgram) and a call that takes and returns the exported
    function's structures (SceneEncoding, tuples, lists, dicts of tensors)."""

    def __init__(self, header: dict, program):
        self.header = header
        self.program = program
        self._module = program.module()

    def __call__(self, *args):
        leaves, spec = _flatten(tuple(args))
        if _sequences_alike(spec) != _sequences_alike(self.header["in_tree"]):
            raise ValueError(f"{self.header['name']}: arguments of another structure than the exported ones")
        with torch.no_grad():
            out = self._module(*leaves)
        return _unflatten(self.header["out_tree"], iter(out))


def load_artifact(path: str) -> Artifact:
    """Deserialize an artifact into a callable. Its graph runs on the
    platform it was exported for (the device its state lies on)."""
    with open(path, "rb") as f:
        header, serialized = _unwrap(f.read())
    return Artifact(header, torch.export.load(io.BytesIO(serialized)))


def export_renderer(
    renderer,
    encoding_example: SceneEncoding,
    path: str,
    platforms: Sequence[str] = ("cpu",),
) -> str:
    """Export a FrameRenderer's frame function: SceneEncoding -> frames,
    render.fast's path (B1 through its registered operator) with the
    renderer's weights. The artifact renders on one device (a renderer's
    eval mesh is not exported).

    :param renderer: eval.creators.FrameRenderer (use_fast=True).
    :param encoding_example: a SceneEncoding with the serving shapes (e.g.
        `renderer.encode(batch)` on one example batch), on the target.
    """
    from playableenvironments_tpu_torch.render.fast import render_frame_fast

    if not renderer.use_fast:
        raise NotImplementedError("the port exports render.fast's frame path (FrameRenderer(use_fast=True))")
    if len(platforms) != 1:
        raise ValueError(
            "fast-path renderer artifacts are single-platform (B1 runs as the kernel on the card and as its plain "
            "version on the CPU); export once per target")
    model, autoencoder = renderer.model, renderer.autoencoder
    scene, image_size, strides = model.scene, renderer.image_size, renderer.patch_strides
    composer = model.composer

    def render(encoding):
        return render_frame_fast(scene, composer, autoencoder, encoding, image_size, patch_strides=strides,
                                 focal_length_multiplier=model.focal_length_multiplier)

    modules = {"composer": composer}
    if autoencoder is not None:
        modules["autoencoder"] = autoencoder
    return export_function(render, (encoding_example,), path, platforms,
                           name=f"render_{image_size[0]}x{image_size[1]}", modules=modules)


def export_interactive(
    playable_model,
    renderer,
    encoding_example: SceneEncoding,
    path_prefix: str,
    platforms: Sequence[str] = ("cpu",),
) -> dict:
    """Export the full interactive loop as three artifacts, so that a
    serving host runs playable generation with no model code:

    - `<prefix>.render.pexp`: SceneEncoding -> frames.
    - `<prefix>.step0.pexp`: (encoding, initial_style, one_hots, variations)
      -> (new_encoding, carries), the first step after a reset (the LSTM
      carries from the learned initial state).
    - `<prefix>.step.pexp`: (encoding, initial_style, carries, one_hots,
      variations) -> (new_encoding, carries), the steps after it.

    The serving loop: reset = frame 0, render; then step and render,
    feeding the carries back (`render.interactive.action_inputs` shapes the
    one-hot actions; zero variations, as play does). The playable model's
    weights are its state.

    :param playable_model: render.playable_model.PlayableEnvironmentModel
        (the dynamics networks are read, in eval mode).
    :param encoding_example: a (B, 1, ...) SceneEncoding at serving shapes.
    :return: {"render": path, "step0": path, "step": path}.
    """
    from playableenvironments_tpu_torch.config import ObjectIds
    from playableenvironments_tpu_torch.render.interactive import action_inputs, interactive_step

    playable_model.eval()
    dynamic = ObjectIds(playable_model.scene).dynamic_objects_count
    device = encoding_example.object_style.device
    one_hots, variations = action_inputs(playable_model, [0] * dynamic, device=device)
    initial_style = encoding_example.object_style

    def step0(encoding, initial_style, one_hots, variations):
        new_encoding, carries = interactive_step(playable_model, encoding, initial_style, [None] * dynamic,
                                                 list(one_hots), list(variations))
        return new_encoding, tuple(carries)

    def step(encoding, initial_style, carries, one_hots, variations):
        new_encoding, new_carries = interactive_step(playable_model, encoding, initial_style, list(carries),
                                                     list(one_hots), list(variations))
        return new_encoding, tuple(new_carries)

    with torch.no_grad():
        carries = step0(encoding_example, initial_style, one_hots, variations)[1]
    leaves, spec = _flatten(carries)
    carries_example = _unflatten(spec, iter([torch.zeros_like(t) for t in leaves]))
    modules = {"playable_model": playable_model}
    return {
        "render": export_renderer(renderer, encoding_example, f"{path_prefix}.render.pexp", platforms),
        "step0": export_function(step0, (encoding_example, initial_style, one_hots, variations),
                                 f"{path_prefix}.step0.pexp", platforms, name="interactive_step0", modules=modules),
        "step": export_function(step, (encoding_example, initial_style, carries_example, one_hots, variations),
                                f"{path_prefix}.step.pexp", platforms, name="interactive_step", modules=modules),
    }
