"""Dataset loaders -> device task banks.

The reference's ``Loader`` ABC (``/root/reference/arcle/loaders/loader.py:8-57``)
parses ARC-format JSON into per-task lists of numpy grids and samples tasks
host-side with ``pick()``.  The batched design keeps that seam (so users
can inject datasets exactly as before, cf. the TestLoader pattern in the
reference's tests/o2arcex.py:10-21) but adds :class:`TaskBank`: every pair
of every task padded into fixed ``[P, H, W] int8`` device arrays with
offset/count indexing, so ``reset`` can gather a task *inside jit* and a
batch of thousands of envs can be re-tasked without host round-trips.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

TaskTuple = Tuple[List[np.ndarray], List[np.ndarray],
                  List[np.ndarray], List[np.ndarray], Dict]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TaskBank:
    """All pairs of a dataset baked into device arrays.

    Train and test pairs are concatenated into one flat pair axis; per-task
    (offset, count) index both splits.  Grids are zero-padded to H x W.
    """

    in_grids: jax.Array      # i8 [P, H, W]
    in_dims: jax.Array       # i8 [P, 2]
    out_grids: jax.Array     # i8 [P, H, W]
    out_dims: jax.Array      # i8 [P, 2]
    train_offset: jax.Array  # i32 [T]
    train_count: jax.Array   # i32 [T]
    test_offset: jax.Array   # i32 [T]
    test_count: jax.Array    # i32 [T]

    @property
    def n_tasks(self) -> int:
        return self.train_offset.shape[0]

    @property
    def n_pairs(self) -> int:
        return self.in_grids.shape[0]

    def pair_index(self, prob: jax.Array, sub: jax.Array,
                   adaptation: jax.Array) -> jax.Array:
        """Flat pair index for (task, subproblem, train-vs-test)."""
        off = jnp.where(adaptation, self.train_offset[prob],
                        self.test_offset[prob])
        return off + sub

    def pair_count(self, prob: jax.Array, adaptation: jax.Array) -> jax.Array:
        return jnp.where(adaptation, self.train_count[prob],
                         self.test_count[prob])


def bake_bank(tasks: Sequence[TaskTuple], H: int = 30, W: int = 30) -> TaskBank:
    """Pack parsed tasks into a :class:`TaskBank`."""
    in_g, in_d, out_g, out_d = [], [], [], []
    tr_off, tr_cnt, te_off, te_cnt = [], [], [], []

    def push(i, o):
        gi = np.zeros((H, W), np.int8)
        go = np.zeros((H, W), np.int8)
        gi[:i.shape[0], :i.shape[1]] = i
        go[:o.shape[0], :o.shape[1]] = o
        in_g.append(gi)
        in_d.append(np.array(i.shape, np.int8))
        out_g.append(go)
        out_d.append(np.array(o.shape, np.int8))

    for ti, to, ei, eo, _desc in tasks:
        tr_off.append(len(in_g))
        tr_cnt.append(len(ti))
        for i, o in zip(ti, to):
            push(i, o)
        te_off.append(len(in_g))
        te_cnt.append(len(ei))
        for i, o in zip(ei, eo):
            push(i, o)

    return TaskBank(
        in_grids=jnp.asarray(np.stack(in_g)),
        in_dims=jnp.asarray(np.stack(in_d)),
        out_grids=jnp.asarray(np.stack(out_g)),
        out_dims=jnp.asarray(np.stack(out_d)),
        train_offset=jnp.asarray(np.array(tr_off, np.int32)),
        train_count=jnp.asarray(np.array(tr_cnt, np.int32)),
        test_offset=jnp.asarray(np.array(te_off, np.int32)),
        test_count=jnp.asarray(np.array(te_cnt, np.int32)),
    )


class Loader(ABC):
    """Injectable dataset seam, API-compatible with the reference ABC."""

    def __init__(self, rng: Optional[np.random.Generator] = None, **kwargs):
        self.rng = rng
        self._pathlist = self.get_path(**kwargs)
        self.data: List[TaskTuple] = self.parse(**kwargs)

    @abstractmethod
    def get_path(self, **kwargs) -> List[str]:
        ...

    @abstractmethod
    def parse(self, **kwargs) -> List[TaskTuple]:
        ...

    def pick(self, data_index: Optional[int] = None, **kwargs) -> TaskTuple:
        """Host-side task sampling (loader.py:41-57).  Unlike the reference,
        an unseeded loader uses its own Generator rather than the global
        numpy RNG (documented divergence; parity tests pin indices)."""
        assert self.data, "Dataset wasn't loaded properly"
        if data_index is None:
            rng = self.rng if self.rng is not None else np.random.default_rng()
            data_index = int(rng.integers(0, len(self.data)))
        assert 0 <= data_index < len(self.data)
        return self.data[data_index]

    def bank(self, H: int = 30, W: int = 30) -> TaskBank:
        return bake_bank(self.data, H, W)


def _parse_arc_json(text: str) -> TaskTuple:
    # native C++ baker first (arcle_tpu/native/bake.cpp), json fallback
    from ..native import bake_task_native
    baked = bake_task_native(text)
    if baked is not None:
        train, test = baked
        return ([i for i, _ in train], [o for _, o in train],
                [i for i, _ in test], [o for _, o in test], {})
    problem = json.loads(text)
    ti = [np.array(d["input"], np.int8) for d in problem["train"]]
    to = [np.array(d["output"], np.int8) for d in problem["train"]]
    ei = [np.array(d["input"], np.int8) for d in problem["test"]]
    eo = [np.array(d["output"], np.int8) for d in problem["test"]]
    return ti, to, ei, eo, {}


_BUNDLED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "data")


class ARCLoader(Loader):
    """ARC-format directory loader (reference loader.py:60-113).

    ``root`` defaults to ``$ARC_DATA_DIR`` or the bundled sample set; the
    original layout (``<root>/training/*.json``, ``<root>/evaluation/*.json``)
    is expected.
    """

    def __init__(self, train: bool = True, root: Optional[str] = None):
        super().__init__(train=train, root=root)

    def get_path(self, **kwargs) -> List[str]:
        root = kwargs.get("root") or os.environ.get("ARC_DATA_DIR") \
            or os.path.join(_BUNDLED, "sample_arc")
        sub = "training" if kwargs.get("train", True) else "evaluation"
        paths = glob.glob(os.path.join(root, sub, "*.json"))
        paths.sort()
        return paths

    def parse(self, **kwargs) -> List[TaskTuple]:
        out = []
        for p in self._pathlist:
            with open(p) as fp:
                task = _parse_arc_json(fp.read())
            task[-1]["id"] = os.path.basename(p).split(".")[0]
            out.append(task)
        return out


class MiniARCLoader(Loader):
    """Mini-ARC loader (reference loader.py:116-157), including the
    ``null -> "0"`` raw-text replacement quirk and the
    description-from-filename convention."""

    def __init__(self, root: Optional[str] = None):
        super().__init__(root=root)

    def get_path(self, **kwargs) -> List[str]:
        root = kwargs.get("root") or os.environ.get("MINIARC_DATA_DIR") \
            or os.path.join(_BUNDLED, "sample_miniarc")
        paths = glob.glob(os.path.join(root, "*.json"))
        paths.sort(key=lambda fn: fn.split("_")[-1])
        return paths

    def parse(self, **kwargs) -> List[TaskTuple]:
        out = []
        for p in self._pathlist:
            with open(p) as fp:
                task = _parse_arc_json(fp.read().replace("null", '"0"'))
            fns = os.path.basename(p).split("_")
            task[-1]["id"] = fns[-1].split(".")[-2]
            task[-1]["description"] = " ".join(fns[0:-1]).strip()
            out.append(task)
        return out


class ListLoader(Loader):
    """Wrap in-memory task tuples — the injectable test seam."""

    def __init__(self, tasks: Sequence[TaskTuple]):
        self._tasks = list(tasks)
        super().__init__()

    def get_path(self, **kwargs):
        return ["<memory>"] * len(self._tasks)

    def parse(self, **kwargs):
        return self._tasks
