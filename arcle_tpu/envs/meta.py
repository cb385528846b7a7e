"""Meta-RL environment layer.

Counterpart of the reference agents' ``CustomO2ARCEnv`` (agents/env.py:14-87):
op 33 swapped to CropGrid, reset-time augmentation (random rot90 + color
permutation), the dense shaped reward, and the task-settable API used by
E-MAML — as a Gymnasium adapter class.  The batched engine's pure
augmentation lives in :mod:`arcle_tpu.envs.augment`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..ops.table import OpTable, o2arc_table
from .gym_compat import O2ARCv2Env


# ---------------------------------------------------------------------------
# Gymnasium adapter
# ---------------------------------------------------------------------------
class CustomO2ARCEnv(O2ARCv2Env):
    """O2ARC with CropGrid at op 33, augmentation, dense reward, and the
    TaskSettable API (agents/env.py:14-87) — Ray-free."""

    def __init__(self, data_loader=None, max_grid_size=(30, 30), colors=10,
                 max_trial=-1, render_mode=None, render_size=None,
                 augment: bool = True, dense: bool = True):
        self.augment = augment
        self.dense = dense
        super().__init__(data_loader, max_grid_size, colors, max_trial,
                         render_mode, render_size)
        self.reset_options = {"adaptation": True, "prob_index": None}

    def _make_table(self, max_trial: int) -> OpTable:
        return o2arc_table(max_trial, crop_at_33=True)

    def reset(self, seed=None, options=None):
        obs, info = super().reset(seed, self.reset_options)
        if self.augment:
            k = int(self.np_random.integers(0, 4))
            perm = self.np_random.permutation(10).astype(np.int8)
            self.input_ = np.copy(np.rot90(perm[self.input_], k=k))
            self.answer = np.copy(np.rot90(perm[self.answer], k=k))
            self._state = self._fresh_state()
            obs, info = self._observation(), self.init_info()
            self.info = info
        return obs, info

    def step(self, action: Dict):
        obs, sparse, term, trunc, info = super().step(action)
        if self.dense:
            reward = self._dense_reward(obs, sparse)
            self.last_reward = reward
            return obs, reward, term, trunc, info
        return obs, sparse, term, trunc, info

    def _dense_reward(self, obs: Dict, sparse: float) -> float:
        """agents/env.py:44-58 in numpy."""
        h, w = (int(v) for v in obs["grid_dim"])
        Ha, Wa = self.answer.shape
        minh, minw = min(h, Ha), min(w, Wa)
        total = minh * minw
        correct = int(np.sum(
            obs["grid"][:minh, :minw] == self.answer[:minh, :minw]))
        if (h <= Ha) == (w <= Wa):
            total += abs(Ha * Wa - h * w)
        else:
            total += abs(h - Ha) * minw + abs(w - Wa) * minh
        return sparse * 100.0 - 1.0 + correct / total

    # ---- TaskSettableEnv API (agents/env.py:66-87) ----
    def sample_tasks(self, n_tasks: int) -> List[int]:
        return list(np.random.choice(len(self.loader.data), n_tasks,
                                     replace=False))

    def get_task(self) -> Optional[int]:
        return self.reset_options.get("prob_index")

    def set_task(self, task: int) -> None:
        self.reset_options = {"adaptation": True, "prob_index": int(task)}
        super(O2ARCv2Env, self).reset(options=self.reset_options)

    def init_adaptation(self) -> None:
        self.adaptation = True
        self.reset_options["adaptation"] = True
        super(O2ARCv2Env, self).reset(options=self.reset_options)

    def post_adaptation(self) -> None:
        self.adaptation = False
        self.reset_options["adaptation"] = False
        super(O2ARCv2Env, self).reset(options=self.reset_options)
