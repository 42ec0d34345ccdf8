"""Joining a `torch.distributed` process group.

Counterpart of `garment4d_tpu/parallel/launch.py`, which joins a JAX
cluster; here, as in the reference (`utils/train_utils.py:49-92`,
`init_dist_pytorch` / `init_dist_slurm`), one process drives one card and
the processes meet in a process group:

  * `pytorch`: torchrun's (or `torch.distributed.launch`'s) environment,
    `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`; the
    old `--local_rank` flag stands in for `LOCAL_RANK`;
  * `slurm`: `SLURM_PROCID`, `SLURM_NTASKS`, `SLURM_LOCALID`; the master is
    the first host of `SLURM_NODELIST`, on `--tcp_port`;
  * no launcher: no process group, world size 1.

The backend is NCCL for CUDA devices and gloo for the CPU unless the
caller names one; the device of a CUDA process is `cuda:LOCAL_RANK`.
"""

from __future__ import annotations

import os
import re
from typing import Mapping, Optional

import torch
import torch.distributed as dist

LAUNCHERS = ("pytorch", "slurm")


def _first_host(nodelist: str) -> str:
    """The first host of a Slurm node list: `node[01-02,05],gpu7` ->
    `node01`, `a,b` -> `a`, `host` -> `host`."""
    m = re.match(r"([^,\[]*)(?:\[([^\]]*)\])?([^,]*)", nodelist.strip())
    if m is None or not (m.group(1) or m.group(2)):
        raise ValueError(f"cannot read the first host of SLURM_NODELIST={nodelist!r}")
    prefix, ranges, suffix = m.groups()
    if ranges is None:
        return prefix + suffix
    first = ranges.split(",")[0].split("-")[0]
    return prefix + first + suffix


def _env_int(env: Mapping[str, str], key: str, launcher: str) -> int:
    if key not in env:
        raise ValueError(f"--launcher {launcher}: {key} is not set")
    return int(env[key])


def process_env(launcher: str, tcp_port: int, local_rank: int = 0,
                env: Optional[Mapping[str, str]] = None) -> dict:
    """{rank, world_size, local_rank, master_addr, master_port} that
    `launcher` gives this process, read from `env` (default os.environ)."""
    env = os.environ if env is None else env
    if launcher == "pytorch":
        return dict(
            rank=_env_int(env, "RANK", launcher),
            world_size=_env_int(env, "WORLD_SIZE", launcher),
            local_rank=int(env.get("LOCAL_RANK", local_rank)),
            master_addr=env.get("MASTER_ADDR", "127.0.0.1"),
            master_port=int(env.get("MASTER_PORT", tcp_port)))
    if launcher == "slurm":
        return dict(
            rank=_env_int(env, "SLURM_PROCID", launcher),
            world_size=_env_int(env, "SLURM_NTASKS", launcher),
            local_rank=_env_int(env, "SLURM_LOCALID", launcher),
            master_addr=_first_host(env.get("SLURM_NODELIST", "")),
            master_port=int(tcp_port))
    raise ValueError(f"--launcher {launcher!r}: expected one of {LAUNCHERS}")


def initialize_distributed(launcher: Optional[str], tcp_port: int = 12345,
                           local_rank: int = 0, backend: Optional[str] = None,
                           device="cuda") -> dict:
    """Join the process group that `launcher` describes; a no-op without
    one. `device` is the kind of device the run uses ("cuda" or "cpu").
    Returns {process_index, process_count, local_rank, device, backend}."""
    device = torch.device(device)
    if launcher is None:
        return dict(process_index=0, process_count=1, local_rank=local_rank,
                    device=device, backend=None)
    info = process_env(launcher, tcp_port, local_rank)
    if device.type == "cuda":
        device = torch.device("cuda", info["local_rank"])
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=f"tcp://{info['master_addr']}:{info['master_port']}",
        world_size=info["world_size"], rank=info["rank"])
    return dict(process_index=dist.get_rank(), process_count=dist.get_world_size(),
                local_rank=info["local_rank"], device=device, backend=dist.get_backend())


def in_group() -> bool:
    """Whether this process is a rank of a process group: the one switch of
    data parallelism (the global BatchNorm statistics and dropout masks, the
    averaged gradients, the reduced losses and eval means)."""
    return dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0, or a process outside any group."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank of the group; a no-op outside one."""
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """End the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def per_process_batch(global_batch: int, process_count: Optional[int] = None) -> int:
    """The rows of a global batch that each process holds (parity with the
    reference's `batch_size // world_size` check, `train_utils.py:70-73`)."""
    n = world_size() if process_count is None else process_count
    if global_batch % n != 0:  # a bare assert vanishes under python -O
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {n}")
    return global_batch // n
