"""The training optimizer.

Port of playableenvironments_tpu/train/state.py::make_optimizer: Adam (AdamW
with weight decay) with the staircase schedule lr * gamma ** (step //
decay_iterations), evaluated, as optax does, at the step count before the
update; per-group rates keyed by the top-level module name, and per-group
freeze steps that hold a group's rate at 0. The JAX TrainState's parameters
and batch statistics are the modules' own; its step count is the
optimizer's. An explicit parameter subset gives the masked optimizers of
the phase-3 trainer (generator and discriminator, each with its own count).
Inside an active parallel mesh, `step()` first averages the gradients over
the ranks (parallel.mesh.reduce_gradients).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from playableenvironments_tpu_torch.parallel import mesh as mesh_lib


class Optimizer:
    """`step()` after backward: sets each group's rate from the schedule at
    the current step count, takes one Adam step, counts it."""

    def __init__(
        self,
        module: nn.Module,
        learning_rate: float,
        gamma: float = 1.0,
        decay_iterations: int = 10000,
        weight_decay: float = 0.0,
        group_learning_rates: Optional[Dict[str, float]] = None,
        group_freeze_steps: Optional[Dict[str, int]] = None,
        betas: Tuple[float, float] = (0.9, 0.999),
        named_parameters: Optional[Iterable[Tuple[str, nn.Parameter]]] = None,
    ):
        """:param named_parameters: the (name, parameter) pairs to step;
        default every parameter of `module`."""
        group_learning_rates = group_learning_rates or {}
        group_freeze_steps = group_freeze_steps or {}
        groups: Dict[str, list] = {}
        named = list(module.named_parameters() if named_parameters is None else named_parameters)
        self.parameters = [param for _, param in named]
        for name, param in named:
            top = name.split(".")[0]
            groups.setdefault(top if top in group_learning_rates else "__main__", []).append(param)
        param_groups = [
            {
                "params": params,
                "name": group,
                "base_lr": group_learning_rates.get(group, learning_rate),
                "freeze_steps": group_freeze_steps.get(group, 0),
            }
            for group, params in groups.items()
        ]
        # optax's adam/adamw: eps 1e-8 outside the square root, bias-corrected
        # moments, decoupled weight decay scaled by the rate.
        cls = torch.optim.AdamW if weight_decay else torch.optim.Adam
        kwargs = dict(betas=betas, eps=1e-8)
        if weight_decay:
            kwargs["weight_decay"] = weight_decay
        self.optimizer = cls(param_groups, lr=learning_rate, **kwargs)
        self.gamma = gamma
        self.decay_iterations = decay_iterations
        self.step_count = 0

    def learning_rate(self, group: dict) -> float:
        if self.step_count < group["freeze_steps"]:
            return 0.0
        return group["base_lr"] * self.gamma ** (self.step_count // self.decay_iterations)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        # optax updates every leaf, with zeros where no gradient flowed; torch
        # skips a parameter whose grad is None, and its moments would lag.
        for param in self.parameters:
            if param.grad is None:
                param.grad = torch.zeros_like(param)
        mesh = mesh_lib.active_mesh()
        if mesh is not None:
            # Data parallelism: the gradients of the global batch, averaged
            # over the ranks, as XLA's psum gives the JAX step.
            mesh_lib.reduce_gradients(self.parameters, mesh)
        for group in self.optimizer.param_groups:
            group["lr"] = self.learning_rate(group)
        self.optimizer.step()
        self.step_count += 1
