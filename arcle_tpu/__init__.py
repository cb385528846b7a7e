"""arcle-tpu: a batched JAX ARC Learning Environment framework.

A from-scratch JAX/XLA re-design of the capabilities of ConfeitoHS/arcle
(reference mounted at /root/reference): the Gymnasium grid-editing
environments (RawARCEnv, ARCEnv, O2ARCv2Env), dataset loaders, action-space
wrappers and the meta-RL training stack, rebuilt as a pure-functional,
batched, jit-compiled engine that steps thousands of environment instances
in lockstep on a GPU and feeds sharded PPO / E-MAML learners via
collectives.  The Gymnasium adapters need the ``gym`` extra; the
transformer policies need the ``flax`` extra.

Layout
------
- ``arcle_tpu.core``     : state pytrees, geometry, flood-fill kernel
- ``arcle_tpu.ops``      : the 35-op grid-operator library (pure functions)
- ``arcle_tpu.envs``     : functional env cores + batched engine + gym adapters
- ``arcle_tpu.loaders``  : dataset loaders -> device task banks
- ``arcle_tpu.wrappers`` : bbox/point action builders, observation filters
- ``arcle_tpu.parallel`` : mesh/sharding helpers for multi-host scale-out
- ``arcle_tpu.training`` : PPO + E-MAML learners, rollout machinery
- ``arcle_tpu.models``   : policy networks (MLP, GPT, DT) and action dists
- ``arcle_tpu.oracle``   : NumPy oracle transcription used by parity tests
"""

__version__ = "0.1.0"

from . import core, ops, envs, loaders, wrappers  # noqa: F401
