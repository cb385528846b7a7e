"""Single run-config dataclass.

The reference scatters hyperparameters across module constants
(train.py:43-59), a fluent builder (emaml.py:161-280) and an unread YAML
(gptconfig.yaml); here one serializable dataclass tree per run (SURVEY.md
§5 disposition)."""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

from ..training.ppo import PPOConfig
from ..training.emaml import EMAMLConfig
from ..models.gpt_config import GPTConfig


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    family: str = "o2arc"           # raw | arc | o2arc | o2arc_crop33 | o2arc_nofill
    max_trial: int = 127            # train.py:62 (max_trial=127)
    episode_limit: int = 100        # TimeLimit(100), train.py:67
    n_envs: int = 4096
    dataset: str = "synthetic"      # synthetic | arc | miniarc
    n_synthetic_tasks: int = 32
    dense_reward: bool = True       # CustomO2ARCEnv shaping
    augment: bool = True
    reset_pool: int = 8            # K>0: per-rollout pre-drawn auto-reset
                                    # pool (envs.core.ResetPool); 0 = off


@dataclasses.dataclass(frozen=True)
class RunConfig:
    seed: int = 0
    algo: str = "ppo"               # ppo | emaml
    model: str = "mlp"              # mlp | gpt
    total_iterations: int = 1000
    checkpoint_every: int = 10      # algo.save cadence (train.py:153-154)
    log_every: int = 1
    checkpoint_dir: str = "./ckpts"
    env: EnvConfig = dataclasses.field(default_factory=EnvConfig)
    ppo: PPOConfig = dataclasses.field(default_factory=PPOConfig)
    emaml: EMAMLConfig = dataclasses.field(default_factory=EMAMLConfig)
    gpt: GPTConfig = dataclasses.field(default_factory=GPTConfig)
    mlp_hidden: Tuple[int, ...] = (1024, 1024, 512, 512, 256, 128)
    # "bfloat16" runs the MLP torso in bf16 (params and the pi/vf heads
    # stay f32); "float32" bit-reproduces the round-1 curve
    mlp_dtype: str = "float32"
    # split the PPO iteration into two jitted units (rollout | update)
    # instead of one fused program, so each unit compiles and runs on its
    # own; numerics identical
    ppo_chunked: bool = False

    def to_json(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return {f.name: enc(getattr(o, f.name))
                        for f in dataclasses.fields(o)}
            if isinstance(o, (tuple, list)):
                return [enc(v) for v in o]
            if hasattr(o, "dtype") or str(type(o)).startswith("<class 'jax"):
                return str(o)
            return o
        return json.dumps(enc(self), indent=2, default=str)


def make_table(env_cfg: EnvConfig):
    from ..ops import raw_table, arc_table, o2arc_table
    f = env_cfg.family
    if f == "raw":
        return raw_table(env_cfg.max_trial)
    if f == "arc":
        return arc_table(env_cfg.max_trial)
    if f == "o2arc_crop33":
        return o2arc_table(env_cfg.max_trial, crop_at_33=True)
    if f == "o2arc_nofill":
        return o2arc_table(env_cfg.max_trial, no_fill=True)
    return o2arc_table(env_cfg.max_trial)


def make_loader(env_cfg: EnvConfig):
    from ..loaders import ARCLoader, MiniARCLoader, SyntheticLoader
    if env_cfg.dataset == "arc":
        return ARCLoader()
    if env_cfg.dataset == "miniarc":
        return MiniARCLoader()
    return SyntheticLoader(env_cfg.n_synthetic_tasks, seed=7)
