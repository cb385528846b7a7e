"""Per-family op tables and the fused ``transition`` / ``step`` kernels.

The reference dispatches ``operations[int(action['operation'])](state,
action)`` through a list of closures built per env class
(o2arcenv.py:76-113, arcenv.py:26-41,110-138).  Here each family is a
static :class:`OpTable` mapping op index -> (group, param, reset_sel flag),
and ``transition`` evaluates all semantic groups once, folding the result
with ``lax.select_n`` — one monomorphic compiled kernel per family that
vmaps cleanly over thousands of envs.

Known reference bugs fixed by design (dispositions documented in
SURVEY.md §7): ARCEnv's ``[None]*35`` construction crash and its
``len(ops)-1`` reward index are corrected to the 27-op intent with Submit
at 26.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.state import EnvState, Action, I8, I32
from . import groups as g
from .groups import (
    G, OBJ, precompute_selection, precompute_shared, answers_match,
    flood_analysis, full_component, FloodInfo,
)


@dataclasses.dataclass(frozen=True)
class OpTable:
    """Static (hashable) op table for one env family."""

    name: str
    group: Tuple[int, ...]
    param: Tuple[int, ...]
    reset_sel: Tuple[bool, ...]
    max_trial: int = -1
    submit_op: int = -1  # index used by the sparse reward check

    @property
    def n_ops(self) -> int:
        return len(self.group)

    def replace(self, **kw) -> "OpTable":
        return dataclasses.replace(self, **kw)

    def op_names(self) -> Tuple[str, ...]:
        """Capitalized names matching the reference's ``op_names``
        convention (base.py:66)."""
        out = []
        obj_names = ["MoveU", "MoveD", "MoveR", "MoveL", "Rotate90",
                     "Rotate270", "FlipH", "FlipV", "FlipD0", "FlipD1"]
        for grp, par in zip(self.group, self.param):
            if grp == G.COLOR:
                out.append(f"Color{par}")
            elif grp == G.FLOOD:
                out.append(f"FloodFill{par}")
            elif grp == G.OBJECT:
                out.append(obj_names[par])
            elif grp == G.COPY:
                out.append("CopyI" if par == 0 else "CopyO")
            elif grp == G.PASTE:
                out.append("Paste")
            elif grp == G.COPY_FROM_INPUT:
                out.append("CopyFromInput")
            elif grp == G.RESET_GRID:
                out.append("ResetGrid")
            elif grp == G.RESIZE_GRID:
                out.append("ResizeGrid")
            elif grp == G.CROP_GRID:
                out.append("CropGrid")
            elif grp == G.SUBMIT:
                out.append("Submit")
            elif grp == G.RESIZE_TO_ANSWER:
                out.append("ResizeToAnswer")
            else:
                out.append("Noop")
        return tuple(out)


def _table(rows, name, max_trial):
    grp, par, rs = zip(*rows)
    sub = grp.index(G.SUBMIT) if G.SUBMIT in grp else -1
    return OpTable(name=name, group=tuple(grp), param=tuple(par),
                   reset_sel=tuple(rs), max_trial=max_trial, submit_op=sub)


def raw_table(max_trial: int = -1) -> OpTable:
    """RawARCEnv: Color0-9, ResizeToAnswer, Submit (arcenv.py:26-41)."""
    rows = [(G.COLOR, c, False) for c in range(10)]
    rows.append((G.RESIZE_TO_ANSWER, 0, False))
    rows.append((G.SUBMIT, 0, False))
    return _table(rows, "RawARCEnv", max_trial)


def arc_table(max_trial: int = 3) -> OpTable:
    """ARCEnv 27-op intent (arcenv.py:110-138, construction bug fixed)."""
    rows = [(G.COLOR, c, False) for c in range(10)]
    rows += [(G.FLOOD, c, False) for c in range(10)]
    rows += [(G.COPY, 0, False), (G.COPY, 1, False), (G.PASTE, 1, False)]
    rows += [(G.COPY_FROM_INPUT, 0, False), (G.RESET_GRID, 0, False),
             (G.RESIZE_GRID, 0, False)]
    rows.append((G.SUBMIT, 0, False))
    return _table(rows, "ARCEnv", max_trial)


def o2arc_table(max_trial: int = -1, crop_at_33: bool = False,
                no_fill: bool = False) -> OpTable:
    """O2ARCv2Env 35-op table (o2arcenv.py:88-113).

    ``crop_at_33`` swaps op 33 to reset_sel(crop_grid) as the agents' env
    does (agents/env.py:23-28).  ``no_fill`` drops the 10 FloodFill ops
    (agents/wrapper.py:53-57, O2ARCNoFillEnv -> 25 ops).
    """
    rows = [(G.COLOR, c, True) for c in range(10)]
    if not no_fill:
        rows += [(G.FLOOD, c, True) for c in range(10)]
    rows += [(G.OBJECT, d, False) for d in
             (OBJ.MOVE_U, OBJ.MOVE_D, OBJ.MOVE_R, OBJ.MOVE_L)]
    rows += [(G.OBJECT, OBJ.ROT_90, False), (G.OBJECT, OBJ.ROT_270, False)]
    rows += [(G.OBJECT, OBJ.FLIP_H, False), (G.OBJECT, OBJ.FLIP_V, False)]
    rows += [(G.COPY, 0, True), (G.COPY, 1, True), (G.PASTE, 1, True)]
    rows += [(G.COPY_FROM_INPUT, 0, True), (G.RESET_GRID, 0, True)]
    rows.append((G.CROP_GRID if crop_at_33 else G.RESIZE_GRID, 0, True))
    rows.append((G.SUBMIT, 0, False))
    name = "O2ARCNoFillEnv" if no_fill else (
        "CustomO2ARCEnv" if crop_at_33 else "O2ARCv2Env")
    return _table(rows, name, max_trial)


# Group index -> implementation, in G.* order (flood handled separately).
_GROUP_FNS = (
    g.noop,             # 0 NOOP
    g.color_fill,       # 1
    None,               # 2 FLOOD (needs FloodInfo)
    g.object_op,        # 3
    g.copy_to_clip,     # 4
    g.paste_from_clip,  # 5
    g.copy_from_input,  # 6
    g.reset_grid,       # 7
    g.resize_grid,      # 8
    g.crop_grid,        # 9
    g.submit,           # 10
    g.resize_to_answer, # 11
)

FLOOD_UNROLL = 2


def transition_deferred(state: EnvState, action: Action, table: OpTable):
    """Pure single-env transition with *deferred* flood fill.

    Returns ``(state', flood_pending, reward_match)``: when the selected op
    is a flood fill whose component did not converge within FLOOD_UNROLL
    sweeps, the grid is left untouched and ``flood_pending`` is True — the
    caller finishes it (batched callers via one scalar ``lax.cond`` over
    the whole batch, see BatchedEnv.step; single-env via :func:`step`).
    ``reward_match`` is answers_match as the sparse reward sees it
    (identical to matching the post-op state for a Submit op, shared with
    the submit candidate instead of recomputed).
    """
    op = jnp.clip(action.operation.astype(I32), 0, table.n_ops - 1)
    grp = jnp.asarray(table.group, I32)[op]
    par = jnp.asarray(table.param, I32)[op]
    do_reset = jnp.asarray(table.reset_sel, jnp.bool_)[op]

    # reset_sel decorator semantics (object.py:10-26): applied before the op.
    state0 = state.replace(
        selected=jnp.where(do_reset, jnp.zeros_like(state.selected),
                           state.selected),
        active=jnp.where(do_reset, jnp.zeros_like(state.active),
                         state.active),
    )

    sel = action.selection
    pre = precompute_selection(sel)
    has_flood = G.FLOOD in table.group
    flood = flood_analysis(state0, pre, FLOOD_UNROLL) if has_flood else None
    shared = precompute_shared(state0, sel, pre, flood)
    cands = []
    for i, fn in enumerate(_GROUP_FNS):
        if i == G.FLOOD:
            # unused branch collapses to a no-op when the family has no
            # flood ops (grp can never select it)
            cands.append(g.flood_fill(state0, sel, pre, par, table, shared)
                         if has_flood else state0)
        else:
            cands.append(fn(state0, sel, pre, par, table, shared))
    new = jax.tree.map(lambda *xs: jax.lax.select_n(grp, *xs), *cands)
    if has_flood:
        pending = (grp == G.FLOOD) & flood.valid & ~flood.converged
    else:
        pending = jnp.zeros((), bool)

    # Sparse-reward match on the post-op state (o2arcenv.py:121-128): a
    # Submit op leaves the grid unchanged unless reset_on_submit re-inited,
    # in which case the fresh grid (= input) is compared instead.
    ros_applied = (state.trials_remain != 0) & (state.reset_on_submit != 0)
    fresh_match = answers_match(state.replace(
        grid=state.input, grid_dim=state.input_dim))
    reward_match = jnp.where(ros_applied, fresh_match, shared.match)
    return new, pending, reward_match


def finish_flood(state: EnvState, action: Action, table: OpTable,
                 pending: jax.Array) -> EnvState:
    """Complete a deferred flood fill: full fixpoint component + masked
    color write.  Safe to run after reward/termination because flood ops
    never affect either on their own step."""
    op = jnp.clip(action.operation.astype(I32), 0, table.n_ops - 1)
    par = jnp.asarray(table.param, I32)[op]
    pre = precompute_selection(action.selection)
    comp = full_component(state.grid, state.grid_dim, pre.px, pre.py)
    grid = jnp.where(pending & comp, par.astype(I8), state.grid)
    return state.replace(grid=grid)


def transition(state: EnvState, action: Action, table: OpTable) -> EnvState:
    """Pure single-env transition: the functional counterpart of the reference's
    ``transition(state, action)`` hook (o2arcenv.py:149-151).  Flood fill
    is completed inline (scalar ``cond`` — executes the fixpoint loop only
    when actually needed; note that under ``vmap`` the cond becomes a
    select and both branches run — batched callers should prefer
    ``transition_deferred`` + ``finish_flood``)."""
    new, pending, _match = transition_deferred(state, action, table)
    if isinstance(pending, jax.Array) and pending.shape == ():
        return jax.lax.cond(
            pending,
            lambda s: finish_flood(s, action, table, jnp.asarray(True)),
            lambda s: s,
            new)
    return new


def _finish_step(state: EnvState, s2: EnvState, op, match, table: OpTable):
    reward = jnp.where(
        (op == table.submit_op) & match, 1.0, 0.0).astype(jnp.float32)
    s2 = s2.replace(
        steps=state.steps + 1,
        last_action_op=op,
        last_reward=reward,
    )
    return s2, reward, s2.terminated != 0


def step(state: EnvState, action: Action, table: OpTable):
    """Single-env step: transition + sparse reward + bookkeeping.

    Returns ``(new_state, reward, terminated)``; ``truncated`` is always
    False at this layer (base.py:73), as in the reference where truncation
    only comes from a TimeLimit wrapper.
    """
    op = jnp.clip(action.operation.astype(I32), 0, table.n_ops - 1)
    new, pending, match = transition_deferred(state, action, table)
    s2 = jax.lax.cond(
        pending,
        lambda s: finish_flood(s, action, table, jnp.asarray(True)),
        lambda s: s,
        new)
    return _finish_step(state, s2, op, match, table)


def step_deferred(state: EnvState, action: Action, table: OpTable):
    """Like :func:`step` but with deferred flood fill: returns
    ``(state, reward, terminated, flood_pending)``.  Reward/termination are
    exact even before the flood patch (flood ops produce neither)."""
    op = jnp.clip(action.operation.astype(I32), 0, table.n_ops - 1)
    s2, pending, match = transition_deferred(state, action, table)
    s2, reward, term = _finish_step(state, s2, op, match, table)
    return s2, reward, term, pending


def _grid_rowcol(grid: jax.Array, w: int = 30):
    """Row/col index arrays for a square [h, w] grid leaf or a flat
    [h*w] one (``w`` is the flat layout's row width — 30 for the ARC
    families, the bank width for small geometries)."""
    if grid.ndim == 2:
        H, W = grid.shape
        rows = jax.lax.broadcasted_iota(I32, (H, W), 0)
        cols = jax.lax.broadcasted_iota(I32, (H, W), 1)
    else:
        lane = jax.lax.broadcasted_iota(I32, grid.shape, 0)
        rows, cols = lane // w, lane % w
    return rows, cols


def answers_match_any(state: EnvState, w: int = 30) -> jax.Array:
    """``answers_match`` (groups.py) generalized to square-or-flat grid
    leaves, for post-step success checks on either engine layout."""
    rows, cols = _grid_rowcol(state.grid, w)
    ad = state.answer_dim.astype(I32)
    dims_eq = jnp.all(state.grid_dim == state.answer_dim)
    inside = (rows < ad[0]) & (cols < ad[1])
    content_eq = jnp.all(jnp.where(inside, state.grid == state.answer, True))
    return dims_eq & content_eq


def exact_ratio(num: jax.Array, den: jax.Array) -> jax.Array:
    """``num / den`` as the correctly rounded float32, for integers
    ``0 <= num <= den < 2**20``, computed with integer operations only.

    XLA's GPU backend divides float32 with a quotient that may be off by
    an ulp or two, so a float division gives the GPU and the CPU (and the
    NumPy reference) different bits.  Here: normalize ``num * 2**s`` into
    ``[den, 2 * den)``, long-divide 24 mantissa bits plus a guard bit,
    round to nearest even with the remainder as sticky bit, and assemble
    the float32 bit pattern."""
    num = jnp.asarray(num, I32)
    den = jnp.maximum(jnp.asarray(den, I32), 1)
    # s = the smallest shift with num << s >= den (num <= den: s <= 20);
    # num << k < den  <=>  num < ceil(den / 2**k), which cannot overflow
    s = sum((num < ((den + (1 << k) - 1) >> k)).astype(I32)
            for k in range(20))
    r = (num << s) - den                    # quotient in [1, 2): lead bit
    m = jnp.ones_like(num)
    for _ in range(23):
        r = r << 1
        bit = r >= den
        r = jnp.where(bit, r - den, r)
        m = (m << 1) | bit.astype(I32)
    r = r << 1
    guard = r >= den
    sticky = jnp.where(guard, r - den, r) != 0
    m = m + (guard & (sticky | ((m & 1) == 1))).astype(I32)
    carry = m >> 24                         # rounding overflowed to 2.0
    bits = ((127 - s + carry) << 23) | ((m >> carry) & 0x7FFFFF)
    q = jax.lax.bitcast_convert_type(bits, jnp.float32)
    return jnp.where(num == 0, jnp.float32(0.0), q)


def pixel_reward(state_after: EnvState, w: int = 30) -> jax.Array:
    """The paper's §4.1 dense reward: ``-(incorrect pixels)/(total)``
    within the answer dims, in [-1, 0] ("penalizes the agent by the ratio
    of incorrect pixels of the next state", arcle_paper.pdf §4.1).  Zero
    exactly when the grid solves the task; the same bits on every backend
    (:func:`exact_ratio`)."""
    rows, cols = _grid_rowcol(state_after.grid, w)
    ad = state_after.answer_dim.astype(I32)
    inside = (rows < ad[0]) & (cols < ad[1])
    wrong = jnp.sum(
        jnp.where(inside, state_after.grid != state_after.answer, False)
    ).astype(I32)
    return -exact_ratio(wrong, ad[0] * ad[1])


def dense_reward(state_after: EnvState, sparse: jax.Array) -> jax.Array:
    """CustomO2ARCEnv shaped reward (agents/env.py:44-58):
    ``100*sparse - 1 + correct_cells/total`` with the size-mismatch
    penalty denominator.  Accepts square [30,30] or flat [900] grids."""
    grid, answer = state_after.grid, state_after.answer
    gd = state_after.grid_dim.astype(I32)
    ad = state_after.answer_dim.astype(I32)
    h, w = gd[0], gd[1]
    Ha, Wa = ad[0], ad[1]
    minh = jnp.minimum(h, Ha)
    minw = jnp.minimum(w, Wa)
    if grid.shape[-2:] == (30, 30):
        H, W = grid.shape
        rows = jax.lax.broadcasted_iota(I32, (H, W), 0)
        cols = jax.lax.broadcasted_iota(I32, (H, W), 1)
    else:
        lane = jax.lax.broadcasted_iota(I32, grid.shape, 0)
        rows, cols = lane // 30, lane % 30
    region = (rows < minh) & (cols < minw)
    correct = jnp.sum(jnp.where(region, grid == answer, False)).astype(I32)
    both = (h <= Ha) == (w <= Wa)
    pen_a = jnp.abs(Ha * Wa - h * w)
    pen_b = jnp.abs(h - Ha) * minw + jnp.abs(w - Wa) * minh
    total = minh * minw + jnp.where(both, pen_a, pen_b)
    return sparse * 100.0 - 1.0 + exact_ratio(correct, total)
