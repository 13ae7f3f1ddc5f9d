"""Process groups for multi-device runs, counterpart of
`open3dsot_tpu/parallel/mesh.py`.

The JAX package runs data parallelism as one program over a device mesh
(GSPMD, or shard_map) and joins hosts with `jax.distributed`. The port runs
one process per card, joined by `torch.distributed`:

- `init_from_env` joins the group that torchrun describes (`RANK`,
  `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), in place of
  JAX's `JAX_COORDINATOR`; `launch` starts such a world itself (main.py's
  `--num_devices`).
- The backend: NCCL for ranks on cards, gloo on the CPU, and gloo by choice
  where two ranks share one card (NCCL refuses two ranks on one GPU). Gloo
  takes CUDA tensors for all_reduce and broadcast but not for every
  collective, so this module uses all_reduce alone: a gather is an
  all_reduce of zero-padded slices, a barrier an all_reduce of one element.
- `rank`, `world_size`, `all_reduce_sum` / `all_reduce_mean`, `barrier`,
  and `local_devices(n)`, which raises where fewer than n cards exist, as
  `make_mesh` does.
- `global_batch()`: inside it a step's batch is the global batch over every
  rank, as JAX's GSPMD step takes it (BatchNorm statistics and losses over
  all of it). `sum_over_batch` sums a tensor over the ranks, and its
  backward sums the cotangents over the ranks too: the BatchNorms
  (models/layers.py::batch_stats) and K6 (ops/sa_fused_train.py) take their
  sums through it. `gather_rows` concatenates the ranks' rows the same way,
  and the trainer computes the losses on it. Each rank's backward then
  gives its part of the gradient of the sum over ranks of the (identical)
  global loss, and the mean of those parts over the ranks (the trainer's
  all_reduce) is the global loss's gradient. The ranks hold equal shares.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def default_backend(device) -> str:
    """NCCL for ranks on cards, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_devices(n: int) -> List[torch.device]:
    """The first n cards of this host; raises where fewer exist (a
    multi-card run never shrinks to fewer cards than asked for)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(f"local_devices: {n} cards requested, {have} available")
    return [torch.device("cuda", i) for i in range(n)]


def rank_device(device, backend: str) -> torch.device:
    """This rank's device for the requested one: 'cuda' names the card of
    the local rank, which gloo ranks may share where the host has fewer
    cards than ranks (NCCL refuses that, so it raises there); any other
    device as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    lr, have = local_rank(), torch.cuda.device_count()
    if lr < have:
        return torch.device("cuda", lr)
    if backend == "nccl" or have == 0:
        raise ValueError(f"local rank {lr} has no card of its own ({have} on this host); two "
                         f"ranks share a card only under the gloo backend")
    return torch.device("cuda", lr % have)


def init_from_env(device="cpu", backend: Optional[str] = None) -> torch.device:
    """Join the process group described by the environment when it holds
    more than one rank (`WORLD_SIZE` > 1); -> this rank's device. A world
    of one joins nothing."""
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n == 1:
        return torch.device(device)
    dev = rank_device(device, backend)
    if not is_initialized():
        init(int(os.environ["RANK"]), n, os.environ.get("MASTER_ADDR", "localhost"),
             int(os.environ["MASTER_PORT"]), dev, backend)
    return dev


def init(rank_: int, world: int, addr: str, port: int, device, backend: str) -> None:
    """Join a group of `world` ranks at tcp://addr:port as `rank_`."""
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank_,
                            world_size=world, **kw)


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(args: Sequence[str], n: int, env: Optional[dict] = None) -> int:
    """Run `python args...` as n ranks of one group on this host, with the
    environment torchrun would give them (and `env`), and wait for all; ->
    the first non-zero exit code, or 0."""
    port = free_port()
    procs = []
    for r in range(n):
        rank_env = dict(os.environ, **(env or {}), RANK=str(r), LOCAL_RANK=str(r),
                        WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                        MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, *args], env=rank_env))
    codes = [p.wait() for p in procs]
    return next((c for c in codes if c), 0)


# --- collectives (all_reduce only) -------------------------------------------

def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks (by the group's backend wherever a group is
    joined, a world of one too), in place; -> t."""
    if is_initialized():
        dist.all_reduce(t)
    return t


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """t averaged over the ranks, in place; -> t."""
    if is_initialized():
        dist.all_reduce(t)
        t.div_(world_size())
    return t


def barrier(device="cpu") -> None:
    """Wait until every rank is here (an all_reduce of one element)."""
    if world_size() > 1:
        dist.all_reduce(torch.zeros(1, device=device))


def mean_of_floats(values: dict, device="cpu") -> dict:
    """A dict of floats averaged over the ranks (one all_reduce)."""
    if world_size() == 1 or not values:
        return values
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64, device=device)
    all_reduce_mean(t)
    return dict(zip(keys, t.tolist()))


# --- the global batch ------------------------------------------------------------

_GLOBAL_BATCH = False


@contextlib.contextmanager
def global_batch(active: bool = True):
    """Inside (when `active` and the world holds more than one rank):
    statistics and losses are taken over the global batch (module
    docstring)."""
    global _GLOBAL_BATCH
    before = _GLOBAL_BATCH
    _GLOBAL_BATCH = bool(active) and world_size() > 1
    try:
        yield
    finally:
        _GLOBAL_BATCH = before


def in_global_batch() -> bool:
    return _GLOBAL_BATCH


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum(t.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone())


def sum_over_batch(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks inside `global_batch()` (differentiably),
    else t itself."""
    return _SumOverRanks.apply(t) if _GLOBAL_BATCH else t


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        r, n = rank(), world_size()
        out = t.new_zeros((n * t.shape[0],) + tuple(t.shape[1:]))
        out[r * t.shape[0]:(r + 1) * t.shape[0]] = t
        ctx.rows = (r * t.shape[0], (r + 1) * t.shape[0])
        return all_reduce_sum(out)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return all_reduce_sum(g.clone())[lo:hi]


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors concatenated on their first axis (rank 0's rows
    first) inside `global_batch()`, differentiably; else t itself. Integer
    and boolean tensors are gathered as they are, without a gradient."""
    if not _GLOBAL_BATCH:
        return t
    if t.is_floating_point():
        return _GatherRows.apply(t)
    with torch.no_grad():
        wide = t.to(torch.int64)
        out = torch.zeros((world_size() * t.shape[0],) + tuple(t.shape[1:]), dtype=torch.int64,
                          device=t.device)
        out[rank() * t.shape[0]:(rank() + 1) * t.shape[0]] = wide
        return all_reduce_sum(out).to(t.dtype)
