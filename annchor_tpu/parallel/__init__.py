"""Multi-device sharding of the pair pipeline.

The reference's only parallelism is single-node: joblib process pools
and numba thread teams fanning out scalar metric calls (reference
annchor/utils.py:110-271, doc/parallelisation.rst:4-32).  The
accelerator equivalent is SPMD over a device mesh: the candidate-pair
axis is embarrassingly parallel, so every hot kernel (batched metric
evaluation, bound features, probability scoring) shards over a
one-dimensional ``pairs`` axis with `jax.shard_map` — each chip
evaluates its slice of the pair block against a replicated (or
anchor-sharded) dataset, and the only collectives are the final
all-gathers XLA inserts at the output (NCCL on GPUs).  The workload is
a pure data-parallel map.

Design notes
------------
* ``mesh_for(n, devices)`` builds the mesh over the devices it is
  given (default: the default backend's) and raises when there are
  too few.  CI passes the virtual CPU devices
  (`--xla_force_host_platform_device_count`) explicitly.
* ``pair_sharded(fn)`` wraps a batched pair kernel
  ``fn(replicated..., per_pair...) -> per_pair`` so that every
  per-pair operand/result is split over the mesh while the dataset
  operands are replicated on every chip.  Pair blocks are padded to a
  multiple of the mesh size by the caller (`pad_to_multiple`).
* Engines opt in automatically when more than one device of the
  default backend is visible (`auto_mesh`).
"""

from __future__ import annotations

import functools
import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PAIR_AXIS = "pairs"

__all__ = [
    "PAIR_AXIS",
    "available_devices",
    "auto_mesh",
    "mesh_for",
    "pad_to_multiple",
    "pair_sharded",
    "sharded_pair_kernel",
]


def available_devices(prefer: str | None = None):
    """Devices for mesh construction: the default backend's devices,
    or an explicitly requested platform ('gpu'/'cpu')."""
    if prefer is not None:
        return jax.devices(prefer)
    return jax.devices()


def mesh_for(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-d ``pairs`` mesh over n of ``devices`` (default: the
    default backend's devices).  Raises when there are fewer than n."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (PAIR_AXIS,))


def auto_mesh() -> Mesh | None:
    """Mesh over all default-backend devices, or None if single-device
    (the common single-chip case: no sharding overhead).

    The *configured* default device decides the backend: a process
    that pins ``jax_default_device`` to a CPU device (the CI /
    virtual-mesh setup) gets the CPU mesh it asked for."""
    if os.environ.get("ANNCHOR_TPU_DISABLE_SHARDING"):
        return None
    devices = None
    dflt = jax.config.jax_default_device
    if dflt is not None:
        platform = getattr(dflt, "platform", str(dflt))
        try:
            devices = jax.devices(platform)
        except RuntimeError:
            devices = None
    if devices is None:
        devices = jax.devices()
    limit = int(os.environ.get("ANNCHOR_TPU_MESH_DEVICES", "0"))
    if limit > 0:
        devices = devices[:limit]
    if len(devices) < 2:
        return None
    return Mesh(np.asarray(devices), (PAIR_AXIS,))


def pad_to_multiple(arrays, multiple: int, axis: int = 0):
    """Pad each array's leading axis to a multiple (edge-replicated so
    padded lanes compute valid, discardable work). Returns (padded, n)."""
    n = arrays[0].shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return list(arrays), n
    out = []
    for a in arrays:
        pad_width = [(0, 0)] * a.ndim
        pad_width[axis] = (0, rem)
        out.append(np.pad(np.asarray(a), pad_width, mode="edge"))
    return out, n


def pair_sharded(fn, mesh: Mesh, n_replicated: int):
    """shard_map a pair kernel over the ``pairs`` axis.

    fn(*replicated, *per_pair) -> per_pair result (or tuple thereof).
    The first ``n_replicated`` arguments are replicated on every chip;
    the rest are split on their leading axis, which must be a multiple
    of the mesh size.
    """

    def specs(args):
        return tuple(
            P() if k < n_replicated else P(PAIR_AXIS)
            for k in range(len(args))
        )

    @functools.wraps(fn)
    def wrapped(*args):
        in_specs = specs(args)
        out_specs = P(PAIR_AXIS)
        sharded = jax.shard_map(
            fn,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=out_specs,
            check_vma=False,
        )
        return sharded(*args)

    return wrapped


def sharded_pair_kernel(kern, mesh: Mesh, n_replicated: int):
    """Jitted, mesh-sharded version of a batched pair kernel.

    Replicated operands are device_put with a replicated sharding once
    per call; per-pair operands must already be padded to a multiple of
    the mesh size (see pad_to_multiple).
    """
    mapped = jax.jit(pair_sharded(kern, mesh, n_replicated))
    repl = NamedSharding(mesh, P())
    split = NamedSharding(mesh, P(PAIR_AXIS))

    def run(*args):
        placed = [
            jax.device_put(a, repl if k < n_replicated else split)
            for k, a in enumerate(args)
        ]
        return mapped(*placed)

    return run
