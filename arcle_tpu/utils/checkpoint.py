"""Checkpoint / resume as NumPy ``.npz`` files.

The reference checkpoints through RLlib's ``algo.save`` every N epochs
(train.py:153-154) plus ad-hoc pickles of successful batches
(train.py:126-128).  Here: the whole training state pytree (params, opt
state, RNG keys, iteration counter) is one ``step_<N>.npz`` file holding
one array per leaf plus the leaves' tree paths, so a restore into a
template of another structure fails loudly instead of mis-assigning
leaves.  Files are written to a temporary name and renamed into place, so
a crash mid-save leaves the previous checkpoint intact."""

from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional

import jax
import numpy as np

_NAME = re.compile(r"^step_(\d+)\.npz$")


def _paths_and_leaves(tree):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    paths = [jax.tree_util.keystr(p) for p, _ in flat]
    return paths, [leaf for _, leaf in flat], treedef


class Checkpointer:
    """``save(step, tree)`` / ``restore(template)`` / ``latest_step()``
    over ``directory``, keeping the newest ``max_to_keep`` steps."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def _file(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.npz")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> None:
        paths, leaves, _ = _paths_and_leaves(tree)
        arrays = [np.asarray(jax.device_get(x)) for x in leaves]
        meta = {"paths": paths, "dtypes": [str(a.dtype) for a in arrays]}
        tmp = self._file(step) + ".tmp"
        with open(tmp, "wb") as fp:
            np.savez(fp, __meta__=np.asarray(json.dumps(meta)),
                     **{f"leaf_{i}": a for i, a in enumerate(arrays)})
        os.replace(tmp, self._file(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._file(old))

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """The saved tree in ``template``'s structure (NumPy leaves), or
        None when there is no checkpoint.  Raises ValueError when the
        saved tree paths or leaf shapes differ from the template's."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        paths, leaves, treedef = _paths_and_leaves(template)
        with np.load(self._file(step), allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if meta["paths"] != paths:
                raise ValueError(
                    f"checkpoint {self._file(step)} holds tree paths "
                    f"{meta['paths']}, the template has {paths}")
            out = []
            for i, (dtype, leaf) in enumerate(zip(meta["dtypes"], leaves)):
                a = z[f"leaf_{i}"]
                if a.dtype != np.dtype(dtype):
                    # dtypes NumPy cannot name in a file (bfloat16) come
                    # back as raw bytes of the same width
                    a = a.view(jax.numpy.dtype(dtype))
                if a.shape != np.shape(leaf):
                    raise ValueError(
                        f"leaf {paths[i]}: saved shape {a.shape}, "
                        f"template shape {np.shape(leaf)}")
                out.append(a)
        return jax.tree_util.tree_unflatten(treedef, out)
