"""Multi-host (multi-process) scale-out utilities.

The reference's distribution story is Ray actor RPC (SURVEY.md §2.6); the
JAX equivalent is single-controller-per-host JAX: every host calls
:func:`init_multihost`, builds the same global mesh over
``jax.devices()``, and materializes its local shard of the env batch —
stepping needs no cross-host communication at all, and learner gradients
all-reduce through the jitted train step (NCCL between GPUs).

Tested with CPU process fakes in tests/test_multihost.py (2 processes x 4
virtual devices), per the SURVEY §4 test strategy.
"""

from __future__ import annotations

import threading
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


class MultihostInitTimeout(RuntimeError):
    """A process failed to join the distributed runtime within the
    timeout — the analog of RLlib's unhealthy-worker gating
    (reference emaml.py:352-354 healthy_worker_ids)."""


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout_s: float = 300.0) -> None:
    """``jax.distributed.initialize`` with failure detection.

    ``jax.distributed.initialize`` blocks forever while any expected
    process is missing; here it runs under a watchdog and raises
    :class:`MultihostInitTimeout` with a diagnosis + restart procedure
    after ``timeout_s``.  Pass the coordinator address, the process count
    and this process's id explicitly.

    Restart procedure on failure: all processes of the job must be
    restarted together — JAX's single-controller model has no elastic
    re-join (unlike Ray's per-worker restart).  Re-launch the job on all
    hosts; env state re-materializes from the seed/options and training
    state from the latest checkpoint (``--resume``).
    """
    err: list = []

    def run():
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id)
        except Exception as e:          # surfaced after join
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise MultihostInitTimeout(
            f"distributed init did not complete within {timeout_s:.0f}s "
            f"(process_id={process_id}, num_processes={num_processes}, "
            f"coordinator={coordinator_address}). One or more processes "
            f"are missing or unreachable. Restart the WHOLE job on all "
            f"hosts (JAX is single-controller, no elastic re-join) and "
            f"resume from the latest checkpoint with --resume.")
    if err:
        raise err[0]


def assert_all_processes_alive(timeout_s: float = 60.0) -> None:
    """Runtime liveness barrier: a tiny cross-process collective under a
    watchdog.  If any host died mid-run the collective never completes and
    this raises :class:`MultihostInitTimeout` instead of hanging the
    training loop (the healthy-workers check of the reference, run
    explicitly between meta-iterations)."""
    if jax.process_count() == 1:
        return
    done: list = []

    def run():
        mesh = Mesh(np.asarray(jax.devices()), ("d",))
        x = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P("d")),
            np.ones((len(jax.local_devices()),), np.float32))
        done.append(float(jnp.sum(x)))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive() or not done:
        raise MultihostInitTimeout(
            f"liveness barrier did not complete within {timeout_s:.0f}s — "
            f"a process is unresponsive. Restart the job on all hosts and "
            f"resume from the latest checkpoint.")


def _make_global(x, mesh: Mesh, spec: P):
    """Build one global array from this process's local slice of ``x``
    (``x`` is the FULL global value computed redundantly per host — fine
    for env states and task banks, which are cheap host-side)."""
    is_key = jnp.issubdtype(x.dtype, jax.dtypes.prng_key) \
        if hasattr(x, "dtype") else False
    raw = jax.random.key_data(x) if is_key else x
    sharding = NamedSharding(mesh, spec)
    n_proc = jax.process_count()
    pid = jax.process_index()
    if spec and spec[0] is not None:
        per = raw.shape[0] // n_proc
        local = np.asarray(raw[pid * per:(pid + 1) * per])
    else:
        local = np.asarray(raw)
    g = jax.make_array_from_process_local_data(sharding, local)
    return jax.random.wrap_key_data(g) if is_key else g


def shard_global_leading(tree, mesh: Mesh, axis: str = "data"):
    """Shard every leaf's leading dim over ``axis`` across ALL hosts.
    Leaves must be full global values (computed identically per host);
    leading dims not divisible by the axis size are replicated."""
    size = mesh.shape[axis]

    def put(x):
        if x.ndim >= 1 and x.shape[0] % size == 0:
            spec = P(axis)
        else:
            spec = P()
        return _make_global(x, mesh, spec)

    return jax.tree.map(put, tree)


def replicate_global(tree, mesh: Mesh):
    return jax.tree.map(lambda x: _make_global(x, mesh, P()), tree)
