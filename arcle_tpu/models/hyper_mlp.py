"""Hypernetwork MLP layers (flax).

:class:`WLinear` / :class:`HyperMLP` — the hypernetwork-style linear
(weights generated from a learned latent z) of the reference MLPPolicy
(agents/models/MLPPolicy.py:6-34), present for parity.  They need the
``flax`` extra.
"""

from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax


class WLinear(nn.Module):
    """Linear layer whose weights are generated from a learned latent z
    (MLPPolicy.py:6-34): theta = fc(z); y = x @ W + b.  The latent is the
    only fast-adapted parameter in the hypernetwork variant."""

    in_features: int
    out_features: int
    z_dim: int = 1000

    @nn.compact
    def __call__(self, x: jax.Array):
        z = self.param("z", nn.initializers.normal(1.0 / self.out_features),
                       (self.z_dim,))
        theta = nn.Dense(self.in_features * self.out_features
                         + self.out_features, name="fc")(z)
        w_sz = self.in_features * self.out_features
        w = theta[:w_sz].reshape(self.in_features, self.out_features)
        b = theta[w_sz:]
        return x @ w + b


class HyperMLP(nn.Module):
    """Stack of WLinear layers with tanh (the reference MLPPolicy shape)."""

    widths: Sequence[int]
    out: int

    @nn.compact
    def __call__(self, x):
        d = x.shape[-1]
        for i, w in enumerate(self.widths):
            x = nn.tanh(WLinear(d, w, name=f"wl_{i}")(x))
            d = w
        return WLinear(d, self.out, name="wl_out")(x)
