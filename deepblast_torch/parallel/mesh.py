"""Process groups and the ``(data, model)`` device mesh
(``deepblast_tpu/parallel/mesh.py``).

The JAX package shards over a 2-D ``(data, model)`` mesh of jax devices.
The port runs one process a GPU under ``torch.distributed`` (NCCL on
CUDA, gloo on the CPU) and keeps the mesh's names as a
``DeviceMesh`` with dimensions ``("data", "model")``:

* ``data`` — data parallelism: each rank takes its rows of the global
  batch (:func:`shard_batch`), and ``DeepBLAST.fit`` wraps the modules it
  trains in ``DistributedDataParallel`` over the rank's ``data`` group,
  which averages the gradients in every backward (the ``psum`` XLA
  inserts under the JAX mesh).
* ``model`` — the JAX package's tensor-parallel axis.  Its ``fit`` places
  the parameters replicated (``shard_params(use_tp=False)``; its
  ``use_tp_params`` is read nowhere, and the port's config drops it), so
  ranks with the same ``data`` coordinate take the same rows and hold
  the same weights: ``tp`` replicates the work, as in JAX, and the
  port's ``fit`` does the same.
  :func:`shard_params` with ``use_tp`` places parameters as DTensors by
  :func:`param_partition_spec`'s rules, but no entry point calls it.

Ranks: :func:`initialize_distributed` once per process (a coordinator
address, or torchrun's environment), then :func:`make_mesh`.  Without a
process group the world is one rank (:func:`world_size`, :func:`rank`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (Replicate, Shard, distribute_module,
                                      distribute_tensor)

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "param_partition_spec",
    "shard_params",
    "shard_batch",
    "world_size",
    "rank",
    "is_writer",
    "launched_by_torchrun",
]

#: the environment torchrun gives each process it starts
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _initialized():
    return dist.is_available() and dist.is_initialized()


def world_size():
    """The ranks of the default process group (1 without one)."""
    return dist.get_world_size() if _initialized() else 1


def rank():
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if _initialized() else 0


def is_writer():
    """True on the rank that writes a run's files (rank 0): several
    processes writing one output directory would race."""
    return rank() == 0


def launched_by_torchrun():
    """True when torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) is set."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def initialize_distributed(coordinator=None, num_processes=None,
                           process_id=None, backend=None):
    """Join the default process group (``jax.distributed.initialize``'s
    place).  With ``coordinator`` (``host:port``, where rank 0 listens, or
    an init URL such as ``file:///shared/store``) the world has
    ``num_processes`` ranks and this is rank ``process_id``; without it
    torchrun's environment says so.  ``backend`` defaults to NCCL when
    CUDA is available, else gloo; a caller that puts two ranks on one card
    passes ``"gloo"`` (NCCL takes one rank a device).  On CUDA the rank's
    device is ``cuda:<LOCAL_RANK>``, or ``cuda:<rank % device_count>``."""
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        kw = dict(init_method=init, world_size=num_processes,
                  rank=process_id)
        me = process_id
    else:
        kw = dict(init_method="env://")
        me = int(os.environ["RANK"])
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", me % torch.cuda.device_count())))
    dist.init_process_group(
        backend or ("nccl" if torch.cuda.is_available() else "gloo"), **kw)


def make_mesh(dp: Optional[int] = None, tp: int = 1, devices=None,
              device_type=None):
    """A ``(data, model)`` ``DeviceMesh`` of ``dp x tp`` ranks over every
    rank, or over ``devices``, a leading run of ranks ``range(k)`` (the
    JAX ``make_mesh``'s ``jax.devices()[:k]``; the other ranks are outside
    the mesh).  ``device_type`` defaults to ``"cuda"`` when CUDA is
    available."""
    n = world_size() if devices is None else len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} devices")
    if devices is not None and (list(devices) != list(range(n))
                                or n > world_size()):
        raise ValueError(f"a mesh spans the leading ranks range(k) of the "
                         f"{world_size()}, not {list(devices)}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (dp, tp),
                            mesh_dim_names=("data", "model"))


def batch_sharding(mesh):
    """The placements of a batch: its leading axis split over ``data``."""
    return (Shard(0),) + (Replicate(),) * (mesh.ndim - 1)


def replicated_sharding(mesh):
    return (Replicate(),) * mesh.ndim


def param_partition_spec(name, tensor, owner):
    """Tensor-parallel placements on the ``(data, model)`` mesh of the
    parameter ``name`` of the module ``owner``: the JAX package's rules in
    PyTorch's layouts.  A ``Linear`` weight is ``(out, in)`` where flax's
    kernel is ``(in, out)``, and a ``Conv1d`` weight ``(out, in, k)`` where
    flax's is ``(k, in, out)``: so ``attn.o`` and ``ff.wo`` shard their
    ``in`` dimension, the other linear weights and the convolutions their
    ``out`` dimension, over ``model``.  Everything else is replicated:
    biases, norms, embeddings (which flax names ``embedding``, not
    ``kernel``) and the LSTM weights, whose stacked gates have no ``out``
    dimension of one gate (flax's cells shard each gate's kernel)."""
    rep = (Replicate(), Replicate())
    if tensor.ndim == 0 or not name.endswith("weight"):
        return rep
    if isinstance(owner, nn.Linear):
        if any(s in name for s in ("attn.o", "ff.wo")):
            return (Replicate(), Shard(1))
        return (Replicate(), Shard(0))
    if isinstance(owner, nn.Conv1d):
        return (Replicate(), Shard(0))
    return rep


def shard_params(module, mesh, use_tp=False):
    """Place ``module``'s parameters on ``mesh`` as DTensors: replicated,
    or with ``use_tp`` by :func:`param_partition_spec`.  Returns the
    module."""
    def place(name, sub, mesh):
        for pname, p in list(sub.named_parameters(recurse=False)):
            full = f"{name}.{pname}" if name else pname
            spec = param_partition_spec(full, p, sub) if use_tp \
                else replicated_sharding(mesh)
            sub.register_parameter(pname, nn.Parameter(
                distribute_tensor(p.detach(), mesh, spec),
                requires_grad=p.requires_grad))

    return distribute_module(module, mesh, place)


def data_shard(mesh, coordinate=None):
    """``(dp, d)``: the ``data`` size of ``mesh`` and this rank's ``data``
    coordinate.  ``mesh`` is a ``DeviceMesh``, or its shape ``(dp, tp)``
    with the rank's ``coordinate`` given (no process group needed)."""
    if coordinate is None:
        coordinate = mesh.get_coordinate()
        if coordinate is None:
            raise ValueError("this rank is not in the mesh")
    dp = mesh[0] if isinstance(mesh, tuple) else mesh.size(0)
    return dp, coordinate[0]


def shard_batch(batch, mesh, stacked=False, coordinate=None):
    """This rank's rows of every array of a batch dict: the ``d``-th of
    ``dp`` equal parts of axis 0, or with ``stacked`` (arrays of K steps,
    ``(K, B, ...)``) of axis 1.  Ranks with the same ``data`` coordinate
    take the same rows (``model`` replicates).  Lists, and arrays without
    the axis, pass through unchanged.  ``coordinate``: see
    :func:`data_shard`."""
    dp, d = data_shard(mesh, coordinate)
    axis = 1 if stacked else 0

    def take(x):
        if isinstance(x, list) or getattr(x, "ndim", 0) <= axis:
            return x
        n = x.shape[axis]
        if n % dp:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{dp} data shards")
        k = n // dp
        return x[(slice(None),) * axis + (slice(d * k, (d + 1) * k),)]

    return {k: take(v) for k, v in batch.items()}
