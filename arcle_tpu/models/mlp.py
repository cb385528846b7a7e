"""MLP policy in plain JAX.

:class:`FCPolicy` is the fcnet the shipped MLP E-MAML run actually uses
(train.py:97-100: [1024,1024,512,512,256,128] tanh) with multi-categorical
action heads for the BBoxWrapper tuple action space.  Its parameter tree
has the flax ``Dense`` layout (``{"params": {"fc_i"|"pi"|"vf": {"kernel",
"bias"}}}``), so checkpoints and tree-walking code see the same names.
The hypernetwork layers of the reference MLPPolicy live in
:mod:`.hyper_mlp` (flax).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def onehot_take(a: jax.Array, idx: jax.Array) -> jax.Array:
    """``take_along_axis(a, idx[..., None], -1)[..., 0]`` as one-hot
    arithmetic: iota-compare + select + reduce fuses into one pass instead
    of a batched 1-element gather.  Select (not multiply) so non-finite
    entries at unselected positions (e.g. -inf-padded logits) don't poison
    the sum with NaN."""
    n = a.shape[-1]
    classes = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    oh = idx[..., None] == classes
    return jnp.sum(jnp.where(oh, a, 0), axis=-1)


def _dense_params(key, fan_in: int, fan_out: int, kernel_init):
    return {"kernel": kernel_init(key, (fan_in, fan_out), jnp.float32),
            "bias": jnp.zeros((fan_out,), jnp.float32)}


def _dense(layer, x, dtype):
    """``x @ kernel + bias`` computed in ``dtype`` (flax ``Dense(dtype=)``
    semantics: inputs and params are cast, params are stored f32)."""
    return (jnp.dot(x.astype(dtype), layer["kernel"].astype(dtype))
            + layer["bias"].astype(dtype))


@dataclasses.dataclass(frozen=True)
class FCPolicy:
    """Tanh MLP torso + multi-categorical action logits + value head.

    Action space = (x1: H, y1: W, x2: H, y2: W, op: n_ops), the
    BBoxWrapper tuple (wrappers/bbox.py:12-20).  Initialisers follow
    flax's ``Dense``: LeCun-normal torso kernels, orthogonal heads
    (scale 0.01 for the logits, 1.0 for the value), zero biases.
    ``dtype`` is the torso's compute dtype; the heads run in float32.
    """

    hidden: Sequence[int] = (1024, 1024, 512, 512, 256, 128)
    n_ops: int = 35
    H: int = 30
    W: int = 30
    dtype: Any = jnp.float32

    @property
    def head_sizes(self):
        return (self.H, self.W, self.H, self.W, self.n_ops)

    def init(self, key: jax.Array, obs: jax.Array):
        keys = jax.random.split(key, len(self.hidden) + 2)
        layers = {}
        d = obs.shape[-1]
        lecun = jax.nn.initializers.lecun_normal()
        for i, width in enumerate(self.hidden):
            layers[f"fc_{i}"] = _dense_params(keys[i], d, width, lecun)
            d = width
        layers["pi"] = _dense_params(keys[-2], d, sum(self.head_sizes),
                                     jax.nn.initializers.orthogonal(0.01))
        layers["vf"] = _dense_params(keys[-1], d, 1,
                                     jax.nn.initializers.orthogonal(1.0))
        return {"params": layers}

    def apply(self, params, obs: jax.Array):
        p = params["params"]
        x = obs
        for i in range(len(self.hidden)):
            x = jnp.tanh(_dense(p[f"fc_{i}"], x, self.dtype))
        logits = _dense(p["pi"], x, jnp.float32)
        value = _dense(p["vf"], x, jnp.float32).squeeze(-1)
        sizes = self.head_sizes
        bounds = [sum(sizes[:i + 1]) for i in range(len(sizes) - 1)]
        return tuple(jnp.split(logits, bounds, axis=-1)), value


def fc_policy_reference(params, obs) -> tuple:
    """Plain NumPy float64 forward of :class:`FCPolicy` (the reference the
    tests and the GPU smoke compare it with): returns (logits [.., sum of
    head sizes], value [..])."""
    p = {k: {n: np.asarray(v, np.float64) for n, v in layer.items()}
         for k, layer in params["params"].items()}
    x = np.asarray(obs, np.float64)
    n_hidden = sum(1 for k in p if k.startswith("fc_"))
    for i in range(n_hidden):
        x = np.tanh(x @ p[f"fc_{i}"]["kernel"] + p[f"fc_{i}"]["bias"])
    logits = x @ p["pi"]["kernel"] + p["pi"]["bias"]
    value = (x @ p["vf"]["kernel"] + p["vf"]["bias"])[..., 0]
    return logits, value


def stack_padded_logits(logits_tuple):
    """Stack heads of unequal width into one [..., H, N] tensor padded
    with -inf (masked classes).  One tensor means one kernel for the
    whole multi-head sample/log-prob/entropy instead of one per head."""
    n = max(l.shape[-1] for l in logits_tuple)
    padded = []
    for l in logits_tuple:
        if l.shape[-1] < n:
            pad = [(0, 0)] * (l.ndim - 1) + [(0, n - l.shape[-1])]
            l = jnp.pad(l, pad, constant_values=-jnp.inf)
        padded.append(l)
    return jnp.stack(padded, axis=-2)


def multi_categorical_sample(key, logits_tuple):
    L = stack_padded_logits(logits_tuple)            # [..., H, N]
    u = jax.random.uniform(key, L.shape, minval=1e-12, maxval=1.0)
    g = -jnp.log(-jnp.log(u))                        # one RNG pass, gumbel
    a = jnp.argmax(L + g, axis=-1).astype(jnp.int32)
    lp = onehot_take(jax.nn.log_softmax(L, -1), a)
    return a, lp.sum(-1)


def multi_categorical_log_prob(logits_tuple, actions):
    L = stack_padded_logits(logits_tuple)
    return onehot_take(jax.nn.log_softmax(L, -1),
                       actions[..., :L.shape[-2]]).sum(-1)


def multi_categorical_entropy(logits_tuple):
    L = stack_padded_logits(logits_tuple)
    ls = jax.nn.log_softmax(L, -1)
    p = jnp.exp(ls)
    # sanitize -inf BEFORE the multiply: p * (-inf) has a NaN derivative
    # (d(p*ls)/dls = p + p*ls) that poisons the backward pass even under
    # a where() — zero the masked entries on both factors instead
    ls_safe = jnp.where(jnp.isfinite(ls), ls, 0.0)
    return -jnp.sum(p * ls_safe, axis=(-2, -1))
