"""Reset-time task augmentation for the batched engine.

The meta-RL envs (agents/env.py:31-42) rotate each reset pair by a random
multiple of 90 degrees and permute its colors.  This is the pure JAX form
that ``envs.core.reset`` applies; the Gymnasium adapter does the same in
NumPy (``envs.meta.CustomO2ARCEnv``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.geometry import dyn_roll
from ..core.state import I8, I32


def augment_task(key: jax.Array, grid: jax.Array, dim: jax.Array,
                 answer: jax.Array, answer_dim: jax.Array, colors: int = 10):
    """Random rot90 + shared color permutation of a padded (grid, answer)
    pair (agents/env.py:31-42).  Background 0 may be permuted too — the
    reference permutes all 10 colors uniformly."""
    kk, kp = jax.random.split(key)
    k = jax.random.randint(kk, (), 0, 4)
    perm = jax.random.permutation(kp, jnp.arange(colors, dtype=I8))

    def rot_padded(g, d):
        H, W = g.shape
        d = d.astype(I32)
        # rot90^k of the h x w block, re-anchored at the origin:
        # k=1: block lands at rows [W-w, W) -> roll up; k=2: both; k=3: cols.
        g1 = dyn_roll(jnp.rot90(g, 1), d[1] - W, 0)
        g2 = dyn_roll(dyn_roll(jnp.rot90(g, 2), d[0] - H, 0), d[1] - W, 1)
        g3 = dyn_roll(jnp.rot90(g, 3), d[0] - H, 1)
        out = jax.lax.select_n(k, g, g1, g2, g3)
        odd = (k % 2) == 1
        nd = jnp.where(odd, d[::-1], d).astype(I8)
        return out, nd

    # apply the permutation with compare-selects (ten fused selects in
    # place of a per-cell table gather)
    def recolor(g):
        out = g
        for c in range(colors):
            out = jnp.where(g == c, perm[c], out)
        return out

    grid = recolor(grid)
    answer = recolor(answer)
    grid, dim = rot_padded(grid, dim)
    answer, answer_dim = rot_padded(answer, answer_dim)
    return grid, dim, answer, answer_dim
