"""Bit-exactness fuzz: the JAX engine against the validated NumPy oracle.

Covers all env families, every state field after every step, sparse reward
and termination, and batch-invariance (vmapped engine must agree with the
single-env path).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from arcle_tpu.core.state import init_state, Action
from arcle_tpu.ops import raw_table, arc_table, o2arc_table, step
from arcle_tpu.oracle import OracleEnv
from arcle_tpu.oracle.oracle_env import FAMILY_FIELDS, STATE_FIELDS

from test_oracle_vs_reference import random_grid, random_selection


def jax_state_from(inp, out, max_trial=-1, reset_on_submit=False):
    H = W = 30
    pad_i = np.zeros((H, W), np.int8)
    pad_i[:inp.shape[0], :inp.shape[1]] = inp
    pad_o = np.zeros((H, W), np.int8)
    pad_o[:out.shape[0], :out.shape[1]] = out
    return init_state(
        jnp.asarray(pad_i), jnp.asarray(np.array(inp.shape, np.int8)),
        jnp.asarray(pad_o), jnp.asarray(np.array(out.shape, np.int8)),
        max_trial=max_trial, reset_on_submit=int(reset_on_submit))


FIELDS = STATE_FIELDS


def assert_state_equal(js, orc_state, t, op, fields=FIELDS):
    for name, get in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(js, name)), np.asarray(get(orc_state)),
            err_msg=f"step {t} op {op} field {name}")


CORE_FIELDS = FAMILY_FIELDS["raw"]
CLIP_FIELDS = FAMILY_FIELDS["arc"]


def run_fuzz(family, table, seed, n_steps, fields, max_trial=3,
             reset_on_submit=False, submit_boost=0.0):
    rng = np.random.default_rng(seed)
    inp = random_grid(rng, int(rng.integers(2, 16)), int(rng.integers(2, 16)))
    out = random_grid(rng, int(rng.integers(2, 16)), int(rng.integers(2, 16)))

    orc = OracleEnv(family, max_trial=max_trial)
    orc.reset(inp, out, reset_on_submit=reset_on_submit)
    js = jax_state_from(inp, out, max_trial, reset_on_submit)
    jstep = jax.jit(step, static_argnums=2)

    for t in range(n_steps):
        op = int(rng.integers(0, table.n_ops))
        if submit_boost and rng.random() < submit_boost:
            op = table.n_ops - 1
        sel = random_selection(rng)
        ostate, orew, oterm = orc.step(sel, op)
        js, jrew, jterm = jstep(
            js, Action(selection=jnp.asarray(sel),
                       operation=jnp.asarray(op, jnp.int32)), table)
        assert_state_equal(js, ostate, t, op, fields)
        assert float(jrew) == orew, f"step {t} op {op} reward"
        assert bool(jterm) == oterm, f"step {t} op {op} terminated"
        if oterm:
            break


@pytest.mark.parametrize("seed", range(6))
def test_o2arc_engine_fuzz(seed):
    run_fuzz("o2arc", o2arc_table(max_trial=3), seed, 300, FIELDS)


@pytest.mark.parametrize("seed", range(3))
def test_o2arc_crop33_engine_fuzz(seed):
    run_fuzz("o2arc_crop33", o2arc_table(max_trial=3, crop_at_33=True),
             seed + 50, 200, FIELDS)


@pytest.mark.parametrize("seed", range(3))
def test_arc_engine_fuzz(seed):
    run_fuzz("arc", arc_table(max_trial=3), seed + 100, 200, CLIP_FIELDS)


@pytest.mark.parametrize("seed", range(3))
def test_raw_engine_fuzz(seed):
    run_fuzz("raw", raw_table(max_trial=3), seed + 200, 120, CORE_FIELDS)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.slow
def test_o2arc_reset_on_submit_engine(seed):
    run_fuzz("o2arc", o2arc_table(max_trial=5), seed + 300, 150, FIELDS,
             max_trial=5, reset_on_submit=True, submit_boost=0.2)


@pytest.mark.slow
def test_vmap_matches_single():
    """Stepping a batch must equal stepping each env alone (semantics are
    batch-size invariant)."""
    table = o2arc_table(max_trial=3)
    rng = np.random.default_rng(9)
    B = 16
    states = []
    for _ in range(B):
        inp = random_grid(rng, int(rng.integers(2, 12)), int(rng.integers(2, 12)))
        out = random_grid(rng, int(rng.integers(2, 12)), int(rng.integers(2, 12)))
        states.append(jax_state_from(inp, out, 3))
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *states)

    vstep = jax.jit(jax.vmap(step, in_axes=(0, 0, None)), static_argnums=2)
    sstep = jax.jit(step, static_argnums=2)

    for t in range(40):
        ops = rng.integers(0, 35, B)
        sels = np.stack([random_selection(rng) for _ in range(B)])
        act = Action(selection=jnp.asarray(sels),
                     operation=jnp.asarray(ops, jnp.int32))
        batched, brew, bterm = vstep(batched, act, table)
        for i in range(B):
            a1 = Action(selection=jnp.asarray(sels[i]),
                        operation=jnp.asarray(int(ops[i]), jnp.int32))
            states[i], r1, t1 = sstep(states[i], a1, table)
            assert float(brew[i]) == float(r1), (t, i)
        single = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
        chex_equal = jax.tree.map(
            lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)),
            batched, single)
        assert all(jax.tree.leaves(chex_equal)), (t, chex_equal)


@pytest.mark.slow
def test_deferred_flood_matches_full():
    """The batched deferred-flood path must equal the inline path even on
    adversarial components needing many sweeps (spiral)."""
    from arcle_tpu.ops import step_deferred, finish_flood
    table = o2arc_table(max_trial=-1)

    # serpentine corridor of color 1: 15 horizontal legs joined alternately
    # at the ends -> needs ~15 sweeps, far beyond the unrolled count
    g = np.full((30, 30), 2, np.int8)
    for r in range(0, 30, 2):
        g[r, :] = 1
    for i, r in enumerate(range(1, 29, 2)):
        g[r, 29 if i % 2 == 0 else 0] = 1
    inp = g
    out = np.ones((3, 3), np.int8)
    js = jax_state_from(inp, out, -1)

    sel = np.zeros((30, 30), np.int8)
    sel[0, 0] = 1  # seed inside the spiral
    act = Action(selection=jnp.asarray(sel), operation=jnp.asarray(14, jnp.int32))

    # oracle ground truth
    orc = OracleEnv("o2arc", max_trial=-1)
    orc.reset(inp, out)
    ostate, _, _ = orc.step(sel, 14)

    # inline path
    js1, _, _ = jax.jit(step, static_argnums=2)(js, act, table)
    np.testing.assert_array_equal(np.asarray(js1.grid), ostate["grid"])

    # deferred + fixup path
    js2, rew, term, pending = jax.jit(step_deferred, static_argnums=2)(
        js, act, table)
    assert bool(pending)   # spiral must exceed the unrolled sweeps
    js2 = jax.jit(finish_flood, static_argnums=2)(js2, act, table, pending)
    np.testing.assert_array_equal(np.asarray(js2.grid), ostate["grid"])


@pytest.mark.slow
def test_batched_env_deferred_flood():
    """BatchedEnv.step (cond-gated fixup) agrees with vmapped step."""
    from arcle_tpu.envs import BatchedEnv
    from arcle_tpu.loaders import ListLoader

    # one env floods a spiral (needs fallback), others do normal ops
    g = np.full((12, 12), 2, np.int8)
    for k in range(0, 6, 2):
        g[k, k:12 - k] = 1
        g[k:12 - k, 11 - k] = 1
    tasks = [([g], [g], [g], [g], {"id": "s"})]
    env = BatchedEnv(table=o2arc_table(max_trial=-1),
                     bank=ListLoader(tasks).bank(), max_trial=-1,
                     episode_limit=0, auto_reset=False)
    B = 4
    bs = env.reset(jax.random.key(0), B)
    sels = np.zeros((B, 30, 30), np.int8)
    sels[0, 0, 0] = 1            # flood seed on spiral
    sels[1, 2, 2] = 1
    sels[2, :3, :3] = 1
    ops = np.array([14, 13, 5, 31], np.int32)
    act = Action(selection=jnp.asarray(sels), operation=jnp.asarray(ops))
    bs2, obs, rew, term, trunc = jax.jit(type(env).step)(env, bs, act)

    vstep = jax.vmap(step, in_axes=(0, 0, None))
    ref_env, ref_rew, ref_term = jax.jit(vstep, static_argnums=2)(
        bs.env, act, env.table)
    np.testing.assert_array_equal(np.asarray(bs2.env.grid),
                                  np.asarray(ref_env.grid))
    np.testing.assert_array_equal(np.asarray(rew), np.asarray(ref_rew))
