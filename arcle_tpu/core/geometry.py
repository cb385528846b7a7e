"""Grid geometry primitives shared by the operator library.

Everything here is a pure function on fixed-shape arrays; positions may be
negative or out of range, handled with whole-grid index arithmetic (masks +
rolls) instead of dynamic slices, because ``lax.dynamic_slice`` clamps
negative starts while the reference semantics (e.g. a floating object
partially off-grid, /root/reference/arcle/actions/object.py:127-138) need
true signed-offset windows.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

I32 = jnp.int32


def row_col_iota(H: int, W: int) -> Tuple[jax.Array, jax.Array]:
    rows = jax.lax.broadcasted_iota(I32, (H, W), 0)
    cols = jax.lax.broadcasted_iota(I32, (H, W), 1)
    return rows, cols


def inside_dims(dim: jax.Array, H: int, W: int) -> jax.Array:
    """Bool [H,W] mask of cells with row < dim[0] and col < dim[1]."""
    rows, cols = row_col_iota(H, W)
    d = dim.astype(I32)
    return (rows < d[0]) & (cols < d[1])


def bbox(mask: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Bounding box of truthy cells: (any, rmin, rmax, cmin, cmax), all i32.

    Counterpart of ``_get_bbox`` (reference object.py:49-58) but total: when
    the mask is empty the reference raises / is never called; here we return
    ``any=False`` and zeros, and callers gate on ``any``.
    """
    m = mask != 0
    rows_any = jnp.any(m, axis=1)
    cols_any = jnp.any(m, axis=0)
    H = m.shape[0]
    W = m.shape[1]
    ridx = jax.lax.broadcasted_iota(I32, (H, 1), 0).squeeze(-1)
    cidx = jax.lax.broadcasted_iota(I32, (W, 1), 0).squeeze(-1)
    big = jnp.asarray(H * W, I32)
    rmin = jnp.min(jnp.where(rows_any, ridx, big))
    rmax = jnp.max(jnp.where(rows_any, ridx, -1))
    cmin = jnp.min(jnp.where(cols_any, cidx, big))
    cmax = jnp.max(jnp.where(cols_any, cidx, -1))
    nonempty = jnp.any(m)
    z = jnp.zeros((), I32)
    return (
        nonempty,
        jnp.where(nonempty, rmin, z),
        jnp.where(nonempty, rmax, z),
        jnp.where(nonempty, cmin, z),
        jnp.where(nonempty, cmax, z),
    )


def dyn_roll(a: jax.Array, shift: jax.Array, axis: int) -> jax.Array:
    """Circular shift by a *traced* per-call amount, without a gather.

    ``jnp.roll`` with a traced shift lowers to an elementwise gather.
    Binary decomposition turns it into ceil(log2(n)) conditional *static*
    rolls, which XLA fuses into one elementwise pass.  Which form is
    faster on the GPU is not measured yet.
    """
    n = a.shape[axis]
    shift = jnp.mod(jnp.asarray(shift, I32), n)
    k = 1
    while k < n:
        bit = (shift & k) != 0
        a = jnp.where(bit, jnp.roll(a, k, axis), a)
        k <<= 1
    return a


def shift2d(a: jax.Array, dx: jax.Array, dy: jax.Array) -> jax.Array:
    """Circular shift: out[i, j] = a[(i - dx) mod H, (j - dy) mod W].

    With an appropriate validity mask this implements arbitrary signed-offset
    window placement without gathers over dynamic starts.
    """
    return dyn_roll(dyn_roll(a, dx, 0), dy, 1)


def window_mask(x: jax.Array, y: jax.Array, h: jax.Array, w: jax.Array,
                H: int, W: int) -> jax.Array:
    """Bool [H,W]: cells (i,j) with x <= i < x+h and y <= j < y+w (signed)."""
    rows, cols = row_col_iota(H, W)
    return (rows >= x) & (rows < x + h) & (cols >= y) & (cols < y + w)


def place_patch(
    patch: jax.Array,       # i8 [H,W], content anchored at origin in [0:h,0:w]
    h: jax.Array, w: jax.Array,
    x: jax.Array, y: jax.Array,
    limit_h: jax.Array, limit_w: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Shift an origin-anchored h x w patch to signed position (x, y).

    Returns ``(values, valid)`` where ``values[i,j] = patch[i-x, j-y]`` and
    ``valid`` marks cells with 0 <= i-x < h, 0 <= j-y < w, i < limit_h,
    j < limit_w.  Because h, w <= H, W the modular roll cannot alias inside
    the valid window.
    """
    H, W = patch.shape
    vals = shift2d(patch, x, y)
    m = window_mask(x, y, h, w, H, W)
    rows, cols = row_col_iota(H, W)
    m = m & (rows < limit_h) & (cols < limit_w)
    return vals, m


def bbox_selection(x1, y1, x2, y2, H: int, W: int) -> jax.Array:
    """Rectangular selection mask from two corners (order-free).

    Functional core of the reference BBoxWrapper (wrappers/bbox.py:22-30).
    """
    x1, y1, x2, y2 = (jnp.asarray(v, I32) for v in (x1, y1, x2, y2))
    xa, xb = jnp.minimum(x1, x2), jnp.maximum(x1, x2)
    ya, yb = jnp.minimum(y1, y2), jnp.maximum(y1, y2)
    rows, cols = row_col_iota(H, W)
    m = (rows >= xa) & (rows <= xb) & (cols >= ya) & (cols <= yb)
    return m.astype(jnp.int8)


def point_selection(x, y, H: int, W: int) -> jax.Array:
    """One-pixel selection mask (wrappers/bbox.py:43-49)."""
    rows, cols = row_col_iota(H, W)
    m = (rows == jnp.asarray(x, I32)) & (cols == jnp.asarray(y, I32))
    return m.astype(jnp.int8)
