"""Rank processes of the port's multi-process tests (no JAX).

`launch(scenario, directory, ranks)` starts `ranks` processes of this file
over gloo on the CPU, as torchrun would (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT on a free port, one PyTorch thread each), waits for
them with a timeout, and kills every one of them and raises when any fails
or the time runs out, so that a rank that dies cannot leave its peers
blocked in a collective. Each rank runs `SCENARIOS[scenario](directory)`,
reading its inputs from `<directory>/inputs.pt` (written by the test, which
builds them with the JAX package where it needs to) and writing
`<directory>/rank<r>.pt`.

Scenarios:
- `steps`: one phase-2 step on a data axis of two ranks, one phase-2 step
  with `remat` on a data 1 x rays 2 mesh, one phase-1 step and one phase-3 fused step
  on a data axis of two, each from the same state and on this rank's slice
  of the global batch; then `verify_replication` on equal and on perturbed
  state, `build_training_mesh`'s validation in two processes, and the
  phase-2 CLI (`cli.train.main`) with each command line of the inputs.
"""

import contextlib
import os
import socket
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(scenario: str, directory: str, ranks: int = 2, timeout: float = 240.0):
    """Run the scenario's ranks; return each rank's saved results."""
    port = free_port()
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(ranks),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PE_DIST_BACKEND="gloo",
                   OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]),
                   WANDB_MODE="disabled")
        log = open(os.path.join(directory, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, directory],
                                       env=env, stdout=log, stderr=subprocess.STDOUT, cwd=directory), log))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                code = proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                failed = f"rank {rank} did not finish within {timeout} s"
                break
            if code != 0:
                failed = f"rank {rank} exited with {code}"
                break
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        logs = "\n".join(f"--- rank {r} ---\n" + open(os.path.join(directory, f"rank{r}.log")).read()[-4000:]
                         for r in range(ranks))
        raise RuntimeError(f"{scenario}: {failed}\n{logs}")
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False) for r in range(ranks)]


def phase2_step(inputs, mesh, batch, rng, remat=False):
    """One phase-2 step (train_step's parts) of the inputs' model on `batch`,
    with `remat` or without: (metrics, gradients, state after)."""
    import dataclasses

    from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
    from playableenvironments_tpu_torch.train import trainer_synthesis

    model = EnvironmentModel(inputs["phase2"]["scene"], device="cpu")
    model.load_state_dict(inputs["phase2"]["state"])
    config = dataclasses.replace(inputs["phase2"]["config"], remat=remat)
    trainer = trainer_synthesis.SynthesisTrainer(model, config)
    trainer.optimizer.step_count = inputs["phase2"]["first_step"]
    model.train()
    with (mesh.activate() if mesh is not None else contextlib.nullcontext()):
        trainer.optimizer.zero_grad()
        loss, metrics, _ = trainer.compute_losses(batch, rng, trainer.step)
        loss.backward()
        trainer.optimizer.step()
        if mesh is not None:
            metrics = mesh.mean_metrics(metrics)
    grads = {name: p.grad.clone() for name, p in model.named_parameters()}
    return {k: v.detach() for k, v in metrics.items()}, grads, model.state_dict()


def phase1_step(inputs, mesh, images, rng):
    from playableenvironments_tpu_torch.train import trainer_autoencoder

    p1 = inputs["phase1"]
    trainer = trainer_autoencoder.AutoencoderTrainer(p1["autoencoder"], p1["config"], device="cpu")
    trainer.model.load_state_dict(p1["state"])
    trainer.model.train()
    with (mesh.activate() if mesh is not None else contextlib.nullcontext()):
        trainer.optimizer.zero_grad()
        loss, metrics, _ = trainer.compute_losses(images, rng)
        loss.backward()
        trainer.optimizer.step()
        if mesh is not None:
            metrics = mesh.mean_metrics(metrics)
    grads = {name: p.grad.clone() for name, p in trainer.model.named_parameters()}
    return {k: v.detach() for k, v in metrics.items()}, grads, trainer.model.state_dict()


def phase3_step(inputs, mesh, encoding, rng):
    """One phase-3 fused step: (metrics, the gradients each optimizer
    stepped with (the generator's, the discriminators'), the state,
    centroids and MI matrices after the pair)."""
    from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
    from playableenvironments_tpu_torch.train import trainer_playable

    p3 = inputs["phase3"]
    model = PlayableEnvironmentModel(p3["scene"], with_discriminators=True, device="cpu")
    model.load_state_dict(p3["state"])
    trainer = trainer_playable.PlayableTrainer(model, p3["config"])
    trainer.centroids = [c.clone() for c in p3["centroids"]]
    trainer.mi_matrices = [m.clone() for m in p3["mi_matrices"]]
    grads = {}
    discriminator_step = trainer.discriminator_step

    def capture(*args):
        # The generator's parameters (the discriminators' gradients of the
        # generator pass are cleared by the discriminator step, unused).
        grads.update({n: p.grad.clone() for n, p in model.named_parameters() if not n.startswith("discriminator")})
        return discriminator_step(*args)

    trainer.discriminator_step = capture
    with (mesh.activate() if mesh is not None else contextlib.nullcontext()):
        metrics = trainer.fused_step(encoding, rng)
        if mesh is not None:
            metrics = mesh.mean_metrics(metrics)
    grads.update({n: p.grad.clone() for n, p in model.named_parameters() if n.startswith("discriminator")})
    return ({k: v.detach() for k, v in metrics.items()}, grads,
            {"state": model.state_dict(), "centroids": trainer.centroids, "mi_matrices": trainer.mi_matrices})


def scenario_steps(directory):
    from playableenvironments_tpu_torch.cli.common import build_training_mesh
    from playableenvironments_tpu_torch.parallel import mesh as mesh_lib
    from playableenvironments_tpu_torch.utils.random import RngStreams

    inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    assert mesh_lib.maybe_initialize_distributed("cpu")
    assert not any(name.split(".")[0] in ("jax", "flax") for name in sys.modules)
    out = {}
    data_mesh = mesh_lib.create_mesh(device="cpu")
    rays_mesh = mesh_lib.create_2d_mesh(data=1, device="cpu")
    out["mesh"] = {"data": (data_mesh.shape, data_mesh.data_index, data_mesh.rays_index),
                   "rays": (rays_mesh.shape, rays_mesh.data_index, rays_mesh.rays_index)}
    batch = inputs["phase2"]["batch"]
    out["phase2"] = phase2_step(inputs, data_mesh, mesh_lib.shard_batch(batch, data_mesh),
                                data_mesh.streams(RngStreams(0, "cpu")))
    out["phase2_rays"] = phase2_step(inputs, rays_mesh, mesh_lib.shard_batch(batch, rays_mesh),
                                     rays_mesh.streams(RngStreams(0, "cpu")), remat=True)
    images = inputs["phase1"]["images"]
    out["phase1"] = phase1_step(inputs, data_mesh, mesh_lib.shard_batch(images, data_mesh),
                                data_mesh.streams(RngStreams(0, "cpu")))
    encoding = inputs["phase3"]["encoding"]
    out["phase3"] = phase3_step(inputs, data_mesh, mesh_lib.shard_batch(encoding, data_mesh),
                                data_mesh.streams(RngStreams(0, "cpu")))

    # verify_replication: equal state passes, a perturbed rank raises on every rank.
    state = {k: v.clone() for k, v in inputs["phase2"]["state"].items()}
    mesh_lib.verify_replication(state)
    if data_mesh.rank == 1:
        next(iter(state.values())).view(-1)[0] += 1.0
    try:
        mesh_lib.verify_replication(state)
        out["verify"] = "passed"
    except ValueError as error:
        out["verify"] = str(error)
    # replicate broadcasts rank 0's copy, after which the check passes.
    mesh_lib.replicate(state)
    mesh_lib.verify_replication(state)

    errors = {}
    for name, mesh_cfg, batch_size in inputs["mesh_cases"]:
        try:
            mesh, is_2d = build_training_mesh({"training": {"mesh": mesh_cfg}}, batch_size, "cpu")
            errors[name] = (mesh.shape, is_2d)
        except ValueError as error:
            errors[name] = str(error)
    out["mesh_cases"] = errors

    # The phase-2 CLI, in this process group, for each command line in turn.
    from playableenvironments_tpu_torch.cli import train

    for argv in inputs["cli_runs"]:
        sys.argv = ["train", *argv]
        train.main()
    assert not any(name.split(".")[0] in ("jax", "flax") for name in sys.modules)
    torch.save(out, os.path.join(directory, f"rank{data_mesh.rank}.pt"))


SCENARIOS = {"steps": scenario_steps}


if __name__ == "__main__":
    torch.set_num_threads(1)
    SCENARIOS[sys.argv[1]](sys.argv[2])
