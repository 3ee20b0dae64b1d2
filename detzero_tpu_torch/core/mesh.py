"""Process groups for data parallelism (port of detzero_tpu/core/mesh.py).

The reference runs one process a host, shards each batch over the `data`
axis of a jax Mesh and lets psum carry the gradient all-reduce, the
masked BN's statistics and the eval gather.  The port runs one process a
card, under torchrun (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) or SLURM (read as the reference reads it), joined by a
torch.distributed process group: NCCL on the card, gloo on the CPU.  The
collectives are explicit: `MaskedBatchNorm` all-reduces its statistics and
their gradients (models/layers.py), `Trainer` averages the gradients and
broadcasts rank 0's state (parallel/trainer.py), and `eval_gather` gathers
per-rank results.  The mesh has the data axis only: no caller of the
reference passes a model axis larger than 1.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
# rank r > 0 adds r * RANK_SEED_STRIDE to a torch seed (rank_seed)
RANK_SEED_STRIDE = 1 << 40
# the reference's SLURM default port (mesh.py:31)
SLURM_PORT = "12355"


@dataclass(frozen=True)
class Mesh:
    """The data axis (DATA_AXIS): `group` (None for one process without a
    group), this process's rank and the world size."""

    group: Any
    rank: int
    world: int


def _launcher_env():
    """(rank, world, local rank, init_method) from torchrun's or SLURM's
    variables, or None when neither launched this process."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        return (int(env["RANK"]), int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", 0)), "env://")
    if "SLURM_PROCID" in env:
        addr = env["SLURM_NODELIST"].split(",")[0]
        port = env.get("MASTER_PORT", SLURM_PORT)
        return (int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                int(env.get("SLURM_LOCALID", 0)), f"tcp://{addr}:{port}")
    return None


def local_rank() -> int:
    """This process's card index on its host (LOCAL_RANK, SLURM_LOCALID;
    0 without a launcher)."""
    launched = _launcher_env()
    return launched[2] if launched else 0


def rank_device(name: str = "cuda") -> torch.device:
    """The device a rank runs on: `name`, where a bare "cuda" means this
    rank's own card, cuda:LOCAL_RANK.  Raises when that card is not
    there; never falls back to another device."""
    device = torch.device(name)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch finds no CUDA device; "
                           f"pass --device cpu to run on the CPU")
    index = local_rank() if device.index is None else device.index
    count = torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(f"rank {get_dist_info()[0]}: cuda:{index} does "
                           f"not exist ({count} card(s) on this host)")
    return torch.device("cuda", index)


def init_distributed(backend: str | None = None, device=None,
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None,
                     timeout_s: float = 1800.0):
    """Joins the process group of this run and returns (rank, world).

    Returns at once when a group exists (a caller that made its own, with
    the backend it chose, keeps it).  The rank, world size and rendezvous
    come from the arguments, else from torchrun's variables (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), else from SLURM's (SLURM_PROCID,
    SLURM_NTASKS, the first node of SLURM_NODELIST and MASTER_PORT or
    12355, as the reference reads them); without any, this is one process
    and no group is made.  The backend is `backend`, else NCCL when
    `device` is a card and gloo otherwise.  A group that cannot be made
    raises: the run never goes on as one process."""
    if dist.is_initialized():
        return get_dist_info()
    launched = _launcher_env()
    if rank is None and launched is None:
        return 0, 1
    if rank is None:
        rank, world_size, _, env_method = launched
        init_method = init_method or env_method
    if world_size is None:
        raise ValueError("init_distributed: a rank without a world size")
    device = torch.device(device) if device is not None else None
    if backend is None:
        backend = "nccl" if device is not None and device.type == "cuda" \
            else "gloo"
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=int(rank),
            world_size=int(world_size),
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(f"rank {rank} of {world_size}: the {backend} "
                           f"process group could not be made ({e})") from e
    return get_dist_info()


def get_dist_info():
    """(rank, world size) of this process; (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_group():
    """The process group of the data axis, or None without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def make_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The data axis over every rank of the process group (one process,
    group None, without one).  `model` must be 1: the port has no model
    axis, as no caller of the reference uses one."""
    if model != 1:
        raise NotImplementedError("the port's mesh has the data axis only "
                                  "(model=1)")
    rank, world = get_dist_info()
    if data is not None and data != world:
        raise ValueError(f"data axis {data} != {world} ranks")
    return Mesh(data_group(), rank, world)


def barrier(mesh: Mesh | None = None):
    group = data_group() if mesh is None else mesh.group
    if group is not None:
        dist.barrier(group=group)


def rank_rng(seed, rank: int | None = None) -> np.random.RandomState:
    """The data draws of a rank: RandomState(seed) on rank 0, as one
    process draws; a RandomState seeded from (seed, rank) on rank r > 0.
    seed None: an unseeded RandomState on every rank."""
    if rank is None:
        rank = get_dist_info()[0]
    if seed is None or rank == 0:
        return np.random.RandomState(seed)
    return np.random.RandomState([int(seed), int(rank)])


def rank_seed(seed: int, rank: int | None = None) -> int:
    """A torch seed of a rank: `seed` on rank 0, seed + rank *
    RANK_SEED_STRIDE on rank r."""
    if rank is None:
        rank = get_dist_info()[0]
    return int(seed) + int(rank) * RANK_SEED_STRIDE


def broadcast_object(obj, mesh: Mesh | None = None):
    """Rank 0's `obj` on every rank (`obj` itself without a group)."""
    group = data_group() if mesh is None else mesh.group
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def shutdown():
    """Leaves the process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
