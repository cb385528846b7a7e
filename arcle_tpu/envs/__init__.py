"""Environment layer: functional cores, batched engine, gym adapters.

The batched engine needs only JAX.  The Gymnasium adapters
(:mod:`.gym_compat`, :mod:`.meta`) need the ``gym`` extra and are imported
on first use of their names.  When gymnasium is installed, its IDs mirror
the reference registrations (/root/reference/arcle/envs/__init__.py:7-25)
so ``gym.make`` call sites keep working, plus the NoFill variant
(agents/wrapper.py:61-65).
"""

from .augment import augment_task
from .core import (
    reset, step, transition, ResetOptions, BatchedEnv, BatchedState,
    batched_reset, batched_step, reset_jit,
)

_GYM_CLASSES = {
    "JaxARCEnvBase": "gym_compat", "RawARCEnv": "gym_compat",
    "ARCEnv": "gym_compat", "O2ARCv2Env": "gym_compat",
    "O2ARCNoFillEnv": "gym_compat", "CustomO2ARCEnv": "meta",
}

_SPECS = [
    ("ARCLE/RawARCEnv-v0", "arcle_tpu.envs.gym_compat:RawARCEnv", None),
    ("ARCLE/ARCEnv-v0", "arcle_tpu.envs.gym_compat:ARCEnv", None),
    ("ARCLE/O2ARCEnv-v2", "arcle_tpu.envs.gym_compat:O2ARCv2Env", None),
    ("ARCLE/O2ARCv2Env-v0", "arcle_tpu.envs.gym_compat:O2ARCv2Env", None),
    ("ARCLE/O2ARCNoFillEnv", "arcle_tpu.envs.gym_compat:O2ARCNoFillEnv", 300),
    ("ARCLE/CustomO2ARCEnv-v0", "arcle_tpu.envs.meta:CustomO2ARCEnv", None),
]


def _register_gym_ids() -> None:
    try:
        from gymnasium.envs.registration import register, registry
    except ImportError:
        return
    for _id, _ep, _steps in _SPECS:
        # compat IDs (may be shadowed if the original arcle package is also
        # installed and registers after us) ...
        if _id not in registry:
            register(id=_id, entry_point=_ep, max_episode_steps=_steps)
        # ... plus an unambiguous namespace that always points here.
        own_id = _id.replace("ARCLE/", "ARCLE-TPU/")
        if own_id not in registry:
            register(id=own_id, entry_point=_ep, max_episode_steps=_steps)


_register_gym_ids()


def __getattr__(name):
    if name in _GYM_CLASSES:
        import importlib
        mod = importlib.import_module(f".{_GYM_CLASSES[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "reset", "step", "transition", "ResetOptions", "BatchedEnv",
    "BatchedState", "batched_reset", "batched_step", "reset_jit",
    "JaxARCEnvBase", "RawARCEnv", "ARCEnv", "O2ARCv2Env",
    "O2ARCNoFillEnv", "CustomO2ARCEnv", "augment_task",
]
