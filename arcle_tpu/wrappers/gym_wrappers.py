"""Gymnasium action/observation wrappers (the compat layer).

Counterparts of /root/reference/arcle/wrappers/bbox.py:9-49 (BBoxWrapper,
PointWrapper) and agents/env.py:89-126 (FilterO2ARC).  They need the
``gym`` extra; the batched engine uses the pure builders in
:mod:`arcle_tpu.wrappers` instead.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Tuple

import gymnasium as gym
import numpy as np
from gymnasium import spaces


class BBoxWrapper(gym.ActionWrapper):
    def __init__(self, env: gym.Env):
        super().__init__(env)
        u = env.unwrapped
        self.action_space = spaces.Tuple((
            spaces.Discrete(u.H), spaces.Discrete(u.W),
            spaces.Discrete(u.H), spaces.Discrete(u.W),
            spaces.Discrete(len(u.operations)),
        ))

    def action(self, action: Tuple):
        x1, y1, x2, y2, op = action
        u = self.env.unwrapped
        sel = np.zeros((u.H, u.W), np.int8)
        x1, x2 = min(x1, x2), max(x1, x2)
        y1, y2 = min(y1, y2), max(y1, y2)
        sel[x1:x2 + 1, y1:y2 + 1] = 1
        return {"selection": sel, "operation": op}


class PointWrapper(gym.ActionWrapper):
    def __init__(self, env: gym.Env):
        super().__init__(env)
        u = env.unwrapped
        self.action_space = spaces.Tuple((
            spaces.Discrete(u.H), spaces.Discrete(u.W),
            spaces.Discrete(len(u.operations)),
        ))

    def action(self, action: Tuple):
        x, y, op = action
        u = self.env.unwrapped
        sel = np.zeros((u.H, u.W), np.int8)
        sel[x, y] = 1
        return {"selection": sel, "operation": op}


class FilterO2ARC(gym.ObservationWrapper):
    """Project the O2ARC dict obs to 9 keys for MLP training
    (agents/env.py:89-126)."""

    def __init__(self, env: gym.Env):
        super().__init__(env)
        u = env.unwrapped
        H, W = u.H, u.W
        self.observation_space = spaces.Dict({
            "trials_remain": spaces.Box(-1, u.max_trial, shape=(1,),
                                        dtype=np.int8),
            "grid": spaces.Box(0, u.colors, (H, W), dtype=np.int8),
            "grid_dim": spaces.Box(low=np.array([1, 1]),
                                   high=np.array([H, W]), dtype=np.int8),
            "clip": spaces.Box(0, u.colors, (H, W), dtype=np.int8),
            "clip_dim": spaces.Box(low=np.array([0, 0]),
                                   high=np.array([H, W]), dtype=np.int8),
            "active": spaces.MultiBinary(1),
            "object": spaces.Box(0, u.colors, (H, W), dtype=np.int8),
            "object_dim": spaces.Box(low=np.array([0, 0]),
                                     high=np.array([H, W]), dtype=np.int8),
            "object_pos": spaces.Box(low=np.array([-128, -128]),
                                     high=np.array([127, 127]),
                                     dtype=np.int8),
        })

    def observation(self, observation):
        o2s = observation["object_states"]
        return OrderedDict([
            ("trials_remain", observation["trials_remain"]),
            ("grid", observation["grid"]),
            ("grid_dim", observation["grid_dim"]),
            ("clip", observation["clip"]),
            ("clip_dim", observation["clip_dim"]),
            ("active", o2s["active"]),
            ("object", o2s["object"]),
            ("object_dim", o2s["object_dim"]),
            ("object_pos", o2s["object_pos"]),
        ])
