"""Device-mesh construction and sharding helpers.

The reference is single-threaded (SURVEY.md §2 "Parallelism inventory":
none of DP/TP/PP/EP, no NCCL/MPI). The renderer's natural axes:

  - ``tiles``: pixels/ray batches sharded across devices (data parallelism —
    rays are embarrassingly parallel, main.cpp:557-578).
  - ``spp``: independent sample streams of the *same* pixels sharded across
    devices; radiance is averaged with a ``psum`` over the axis (the
    renderer's gradient-accumulation analogue).

On a multi-GPU host every card reaches every other over NVLink at the same
rate, so the mesh shape follows the algorithm alone.

Multi-host runs initialise jax.distributed and use the same mesh over the
global device set; tests use an 8-device CPU mesh
(--xla_force_host_platform_device_count, SURVEY.md §4).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401

AXIS_TILES = "tiles"
AXIS_SPP = "spp"


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (AXIS_TILES,),
    devices=None,
) -> Mesh:
    devices = list(jax.devices()) if devices is None else list(devices)
    if shape is None or len(shape) == 0:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    dev_arr = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev_arr, tuple(axis_names))


def ray_sharding(mesh: Mesh, axis: str = AXIS_TILES) -> NamedSharding:
    """[N, ...] ray-array sharding: leading axis split over `axis`."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_distributed_if_needed() -> None:
    """Multi-host bring-up — the MPI/NCCL init the reference never had (it
    is single-process, SURVEY.md §5).

    MUST be called before anything touches the jax backend: jax.devices()
    or jax.process_count() initialize it, after which
    jax.distributed.initialize() raises. The launcher is detected purely
    from environment variables (no jax calls):

      - explicit: JAX_COORDINATOR_ADDRESS (or COORDINATOR_ADDRESS) +
        JAX_NUM_PROCESSES + JAX_PROCESS_ID — used by the multi-process
        CPU-mesh test (tests/test_multiprocess.py) and manual launches;
      - auto: SLURM multi-task allocations, where
        jax.distributed.initialize() self-configures.

    Single-process runs (none of the variables set) are untouched. Calling
    twice is a no-op. cli.main() and bench.py call this first thing.
    """
    import os

    if jax.distributed.is_initialized():
        return
    env = os.environ
    addr = env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS")
    nproc = env.get("JAX_NUM_PROCESSES")
    pid = env.get("JAX_PROCESS_ID")
    # SLURM auto-config only when the allocation actually describes a
    # multi-task jax launch: a single-process run inside a SLURM allocation
    # (CI, interactive srun shells) must not hang waiting for a coordinator.
    slurm_multi = (
        "SLURM_JOB_ID" in env and int(env.get("SLURM_NTASKS", "1") or 1) > 1
    )
    auto = slurm_multi
    if addr is None and not auto:
        return
    kwargs = {}
    if addr is not None:
        kwargs["coordinator_address"] = addr
    if nproc is not None:
        kwargs["num_processes"] = int(nproc)
    if pid is not None:
        kwargs["process_id"] = int(pid)
    try:
        jax.distributed.initialize(**kwargs)
    except Exception:
        if addr is not None or not auto:
            raise  # an explicit launch config that fails must be loud
        # auto-detection misfired (SLURM env without a jax-compatible
        # layout): fall back to single-process
        import warnings

        warnings.warn(
            "jax.distributed.initialize() auto-config failed; continuing "
            "single-process", RuntimeWarning, stacklevel=2,
        )
