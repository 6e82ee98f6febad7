"""Data-parallel execution for the trainers.  Port of
``meg_decoding_tpu/parallel/dp.py`` (``:21-63``).

The JAX package trains on a 1-D ``data`` mesh: parameters replicated, the
batch split along its leading axis, XLA inserting the gradient reduction.
Here one process drives one device in a ``torch.distributed`` group (NCCL
for CUDA, gloo for the CPU, as JAX's ``cpu_collectives: gloo``); the
collectives are explicit (``core/mesh.py``): the sharded CLIP loss
(``objectives/clip.py:clip_loss_sharded``), synced BatchNorm
(``ops/batchnorm.py``) and one flat all-reduce of the gradients a step
(``train/steps.py``).

A group comes from the config's ``distributed:`` block
(``coordinator_address``, ``num_processes``, ``process_id``, optional
``timeout_s``; the address is ``file:///path``, ``tcp://host:port`` or
``host:port``) or from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``).  ``launch_ranks`` starts the processes
itself: the train CLIs call it when more than one GPU is visible and no
group is set, since the JAX trainer's one process uses every visible chip.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from meg_decoding_tpu_torch.core.mesh import DataMesh, make_mesh, shard_batch
from meg_decoding_tpu_torch.models.layers import set_data_parallel

__all__ = ["maybe_distributed_init", "setup_data_parallel", "launch_ranks",
           "wants_launch", "all_reduce_flat_", "finish_distributed",
           "run_cli"]

DEFAULT_TIMEOUT_S = 600.0


def _init_method(address: str) -> str:
    if address.startswith(("file://", "tcp://", "env://")):
        return address
    return f"tcp://{address}"


def maybe_distributed_init(cfg, device: torch.device) -> torch.device:
    """Join the process group the config or the environment describes and
    return this rank's device (``cuda:LOCAL_RANK``, else ``cuda:rank mod
    devices``; the CPU stays the CPU).  Without a ``distributed:`` block
    and outside torchrun, nothing happens and ``device`` is returned.
    A failed rendezvous raises; there is no single-process fallback."""
    device = torch.device(device)
    block = cfg.get("distributed") if hasattr(cfg, "get") else None
    env = os.environ
    if block:
        keys = ("coordinator_address", "num_processes", "process_id")
        if not hasattr(block, "get") or any(block.get(k) is None for k in keys):
            raise ValueError(f"distributed: needs {', '.join(keys)}, got {block!r}")
        init = _init_method(str(block["coordinator_address"]))
        world, rank = int(block["num_processes"]), int(block["process_id"])
        timeout_s = float(block.get("timeout_s", DEFAULT_TIMEOUT_S))
    elif "RANK" in env and "WORLD_SIZE" in env:
        init, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
        timeout_s = DEFAULT_TIMEOUT_S
    else:
        return device
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return device


def setup_data_parallel(cfg, device: torch.device):
    """Returns ``(mesh | None, shard_fn | None, replicate_fn)``.

    Engages under an initialized process group unless ``data_parallel`` is
    false.  A group of one rank engages it too: a ``distributed:`` block
    of one process runs the route several GPUs run (the collectives at
    world size 1).  ``shard_fn`` takes this rank's rows of a global batch
    tuple (``core/mesh.py:shard_batch``); ``replicate_fn`` broadcasts a
    train state's parameters and buffers from rank 0 in one flat
    broadcast, so every rank starts from the same copy, and gives the
    model the mesh (``models/layers.py:set_data_parallel``: synced
    BatchNorm, EEGNet's dropout over the global batch)."""
    enabled = bool(cfg.get("data_parallel", True)) if hasattr(cfg, "get") else True
    if not (dist.is_initialized() and enabled):
        return None, None, lambda state: state
    mesh = make_mesh(device)

    def shard_fn(batch):
        return shard_batch(mesh, batch)

    def replicate_fn(state):
        tensors = [t for t in (*state.model.parameters(),
                               *state.model.buffers(), state.temp)
                   if t.dtype == torch.float32]
        with torch.no_grad():
            flat = torch.cat([t.detach().reshape(-1) for t in tensors])
            mesh.broadcast_(flat)
            off = 0
            for t in tensors:
                n = t.numel()
                t.copy_(flat[off:off + n].view(t.shape))
                off += n
        set_data_parallel(state.model, mesh)
        return state

    return mesh, shard_fn, replicate_fn


def all_reduce_flat_(tensors: list[torch.Tensor], mesh: DataMesh) -> None:
    """SUM all-reduce a list of f32 tensors in place through ONE flat
    buffer: one collective for all the gradients of a step, not one each."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    mesh.all_reduce_(flat)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n


def wants_launch(cfg, device: torch.device) -> int:
    """The number of processes the CLI should start itself: the visible
    GPUs when more than one is visible, no group is set (no
    ``distributed:`` block, not under torchrun) and ``data_parallel`` is
    on; else 0 (train in this process)."""
    if torch.device(device).type != "cuda" or not bool(cfg.get("data_parallel", True)):
        return 0
    if cfg.get("distributed") or "RANK" in os.environ:
        return 0
    n = torch.cuda.device_count()
    return n if n > 1 else 0


def launch_ranks(module: str, argv: list[str], n: int,
                 timeout_s: float | None = None) -> int:
    """Run ``python -m module argv…`` as ``n`` ranks of one group that meet
    in a fresh ``file://`` store, each with ``distributed.*`` overrides for
    its rank; wait for all and return the first non-zero exit code (the
    others are then stopped), else 0."""
    with tempfile.TemporaryDirectory(prefix="dp_rendezvous_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", module, *argv,
             f"+distributed.coordinator_address=file://{store}",
             f"+distributed.num_processes={n}",
             f"+distributed.process_id={r}"]) for r in range(n)]
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        rc = 0
        try:
            while any(p.poll() is None for p in procs):
                failed = [p.returncode for p in procs
                          if p.returncode not in (None, 0)]
                if failed or (deadline is not None and time.monotonic() > deadline):
                    rc = failed[0] if failed else 124
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        return rc or next((p.returncode for p in procs if p.returncode), 0)


def finish_distributed() -> None:
    """Leave the process group, if this process is in one (the end of a
    CLI run)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def run_cli(module: str, args, cfg, run):
    """A train CLI's main after parsing (``args``: config_path,
    config_name, device, overrides): start one rank of ``python -m
    module`` a GPU when ``wants_launch`` says so, else ``run(cfg,
    device=…)`` here and leave the group after it.  Returns run's result
    ({} for the launching process); a failed rank's exit code ends the
    launcher."""
    nproc = wants_launch(cfg, args.device)
    if nproc:
        rc = launch_ranks(module, ["--config-path", args.config_path,
                                   "--config-name", args.config_name,
                                   "--device", args.device, *args.overrides],
                          nproc)
        if rc:
            raise SystemExit(rc)
        return {}
    try:
        return run(cfg, device=args.device)
    finally:
        finish_distributed()
