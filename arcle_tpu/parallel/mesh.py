"""Device-mesh scale-out helpers.

The reference's only parallelism is process-level env data-parallelism via
Ray rollout workers plus a single-GPU learner (SURVEY.md §2.6).  The
JAX equivalents:

* env-batch **data parallelism**: the lockstep batch axis of
  ``BatchedState`` sharded over the mesh ``data`` axis — stepping is
  embarrassingly parallel, no collectives;
* learner DP: params replicated, batch sharded; XLA inserts the ``psum``
  gradient all-reduce (NCCL over NVLink) when the jitted train step consumes a
  sharded batch;
* optional **tensor parallelism** of wide MLP layers over a ``model``
  axis (kernel columns sharded), for policies that outgrow one chip.

Multi-host: initialize with ``jax.distributed.initialize()`` per host and
build the mesh from ``jax.devices()`` — env stepping needs no cross-host
communication, gradients all-reduce through the same jitted step.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              devices=None) -> Mesh:
    """Mesh over available devices; default = 1-D data mesh."""
    devices = devices if devices is not None else jax.devices()
    if shape is None:
        shape = (len(devices),)
    dev_arr = np.asarray(devices).reshape(shape)
    return Mesh(dev_arr, axis_names)


def data_model_mesh(n_model: int = 1, devices=None) -> Mesh:
    """2-D (data, model) mesh: model axis for tensor-parallel layers."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    assert n % n_model == 0, (n, n_model)
    return make_mesh((n // n_model, n_model), ("data", "model"),
                     devices)


def shard_leading(tree, mesh: Mesh, axis: str = "data"):
    """Shard every leaf's leading axis over ``axis`` (env batch / rollout
    batch).  Leaves whose leading dim doesn't divide are replicated."""
    size = mesh.shape[axis]

    def put(x):
        if hasattr(x, "shape") and x.ndim >= 1 and x.shape[0] % size == 0:
            spec = P(axis, *([None] * (x.ndim - 1)))
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree)


def replicate(tree, mesh: Mesh):
    return jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree)


def shard_params_tp(params, mesh: Mesh, axis: str = "model",
                    min_cols: int = 256):
    """Tensor-parallel placement for MLP-style params: 2-D kernels with
    enough columns are sharded column-wise over ``axis`` (each device holds
    a slice of the output features; XLA inserts the all-gather/reduce
    pattern), everything else replicated."""
    size = mesh.shape[axis]

    def put(x):
        if (hasattr(x, "ndim") and x.ndim == 2 and x.shape[1] >= min_cols
                and x.shape[1] % size == 0):
            spec = P(None, axis)
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, params)
