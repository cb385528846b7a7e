"""Tests for the paper §4.1 answer-given benchmark suite.

Covers: the pixel reward / terminate-on-match env modes, the 5x5
color-only engine, the color-equivariant policy property (§4.1.2), the
factorized non-sequential control, and a mechanical end-to-end PPO
iteration with every aux-loss ablation cell (Figure 5 ladder).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arcle_tpu.benchmarks import (
    RandomPairLoader, answer_given_agent, answer_given_env, answer_obs,
    color_table, make_policy,
)
from arcle_tpu.core.state import Action
from arcle_tpu.ops.table import answers_match_any, pixel_reward


def _bbox_sel(h, w, x1, y1, x2, y2):
    s = np.zeros((h, w), np.int8)
    s[min(x1, x2):max(x1, x2) + 1, min(y1, y2):max(y1, y2) + 1] = 1
    return s


# ---------------------------------------------------------------------------
# Environment semantics
# ---------------------------------------------------------------------------
def test_exact_ratio_matches_ieee_division():
    """The integer-only quotient behind the rewards is the correctly
    rounded float32 for every num <= den <= 900 (every reward a 30x30 grid
    can produce), bit for bit."""
    from arcle_tpu.ops.table import exact_ratio
    den = np.repeat(np.arange(1, 901, dtype=np.int32), 901)
    num = np.tile(np.arange(0, 901, dtype=np.int32), 900)
    keep = num <= den
    num, den = num[keep], den[keep]
    got = np.asarray(jax.jit(exact_ratio)(num, den))
    want = num.astype(np.float32) / den.astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.slow
def test_pixel_reward_and_match():
    env = answer_given_env(n_tasks=4, h=5, w=5, colors=10, seed=0,
                           episode_limit=50)
    bs = env.reset(jax.random.key(0), 8)
    st = bs.env
    # make every env's answer known, then color the full grid wrong
    sel = jnp.asarray(np.stack([_bbox_sel(5, 5, 0, 0, 4, 4)] * 8))
    wrong_color = (st.answer[:, 0, 0].astype(jnp.int32) + 1) % 10
    act = Action(selection=sel, operation=wrong_color)
    bs2, obs, rew, term, trunc = env.step(bs, act)
    # at least cell (0,0) is wrong everywhere -> reward < 0, no termination
    assert np.all(np.asarray(rew) < 0.0)
    assert np.all(np.asarray(rew) >= -1.0)
    assert not np.any(np.asarray(term))

    # now paint the exact answer cell by cell -> reward hits 0, terminates
    st = bs2.env
    for r in range(5):
        for c in range(5):
            sel1 = np.zeros((8, 5, 5), np.int8)
            sel1[:, r, c] = 1
            op = st.answer[:, r, c].astype(jnp.int32)
            bs2, obs, rew, term, trunc = env.step(
                dataclasses.replace(bs2, env=st), Action(
                    selection=jnp.asarray(sel1), operation=op))
            st = obs  # pre-reset state
    assert np.allclose(np.asarray(rew), 0.0)
    assert np.all(np.asarray(term))


def test_pixel_reward_formula():
    env = answer_given_env(n_tasks=2, h=5, w=5, colors=10, seed=1)
    bs = env.reset(jax.random.key(1), 4)
    st = bs.env
    wrong = np.asarray((st.grid != st.answer).sum(axis=(1, 2)))
    r = np.asarray(jax.vmap(pixel_reward)(st))
    np.testing.assert_allclose(r, -wrong / 25.0, rtol=1e-6)


def test_match_any_flat_and_square():
    env = answer_given_env(n_tasks=2, h=5, w=5, colors=4, seed=2)
    bs = env.reset(jax.random.key(2), 4)
    st = bs.env.replace(grid=bs.env.answer, grid_dim=bs.env.answer_dim)
    assert np.all(np.asarray(jax.vmap(answers_match_any)(st)))
    st2 = bs.env
    m = np.asarray(jax.vmap(answers_match_any)(st2))
    ref = np.asarray((st2.grid == st2.answer).all(axis=(1, 2)))
    np.testing.assert_array_equal(m, ref)


def test_reward_helpers_flat_layout():
    """pixel_reward / answers_match_any on flat [900] grid leaves (the
    30x30 engine's flattened carry layout) agree with the square path."""
    from arcle_tpu.envs.core import flatten_grids
    from arcle_tpu.loaders import SyntheticLoader
    from arcle_tpu.envs import BatchedEnv
    from arcle_tpu.ops import o2arc_table

    env = BatchedEnv(table=o2arc_table(), bank=SyntheticLoader(4).bank())
    bs = env.reset(jax.random.key(0), 8)
    sq = bs.env
    fl = flatten_grids(sq)
    r_sq = np.asarray(jax.vmap(pixel_reward)(sq))
    r_fl = np.asarray(jax.vmap(pixel_reward)(fl))
    np.testing.assert_allclose(r_sq, r_fl, rtol=1e-6)
    m_sq = np.asarray(jax.vmap(answers_match_any)(sq))
    m_fl = np.asarray(jax.vmap(answers_match_any)(fl))
    np.testing.assert_array_equal(m_sq, m_fl)


def test_color_table_shape():
    t = color_table(10)
    assert t.n_ops == 10
    assert t.submit_op == -1
    assert t.op_names() == tuple(f"Color{c}" for c in range(10))


def test_random_pair_loader_distribution():
    ld = RandomPairLoader(16, h=5, w=5, colors=4, seed=3)
    bank = ld.bank(H=5, W=5)
    assert bank.in_grids.shape == (32, 5, 5)   # 1 train + 1 test per task
    assert int(bank.in_grids.max()) < 4
    assert bank.n_tasks == 16


# ---------------------------------------------------------------------------
# Policy architecture (§4.1.2)
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_color_equivariance_property():
    """The defining property of the §4.1.2 color-equivariant policy:
    permuting the task's colors together with the color-embedding rows
    permutes the color-op logits/bbox heads and leaves the value
    invariant — exactly."""
    model = make_policy(h=5, w=5, colors=6, n_layer=2, n_head=2, n_embd=32,
                        color_equivariant=True)
    env = answer_given_env(n_tasks=2, h=5, w=5, colors=6, seed=4)
    bs = env.reset(jax.random.key(3), 4)
    agent = answer_given_agent(model)
    obs = agent.obs_fn(bs.env)
    params = agent.init_fn(jax.random.key(4), obs)

    perm = np.array([2, 0, 1, 5, 3, 4])   # permutation of the 6 colors
    inv = np.argsort(perm)

    def fwd(params, obs):
        from arcle_tpu.benchmarks.answer_given import _unpack
        g, gd, a, ad = _unpack(obs, 5, 5)
        z = jnp.zeros((g.shape[0],), jnp.int8)
        return model.apply(params, g, gd, a, ad, z, z)

    out = fwd(params, obs)

    # permute inputs (grid & answer colors) and the color-emb table rows
    st = bs.env
    pg = jnp.asarray(perm, jnp.int8)[st.grid.astype(jnp.int32)]
    pa = jnp.asarray(perm, jnp.int8)[st.answer.astype(jnp.int32)]
    st_p = st.replace(grid=pg, answer=pa)
    obs_p = agent.obs_fn(st_p)
    # new_emb[perm[v]] must equal old_emb[v]: rows move by the inverse
    params_p = jax.tree_util.tree_map_with_path(
        lambda path, x: x[jnp.asarray(inv)]
        if any(getattr(p, "key", None) == "color_encoder" for p in path)
        else x, params)
    out_p = fwd(params_p, obs_p)

    # op token c in the permuted model corresponds to original token
    # inv[c]... i.e. logits_p[c] == logits[inv[c]]
    np.testing.assert_allclose(np.asarray(out_p["op_logits"]),
                               np.asarray(out["op_logits"])[:, inv],
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(out_p["value"]),
                               np.asarray(out["value"]),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(out_p["bbox_mean_all"]),
                               np.asarray(out["bbox_mean_all"])[:, inv],
                               rtol=5e-3, atol=5e-3)


def test_non_equivariant_breaks_property():
    """With color_equivariant=False (the reference-GPT op tokens) the same
    permutation does NOT permute the logits — the flag is load-bearing."""
    model = make_policy(h=5, w=5, colors=6, n_layer=2, n_head=2, n_embd=32,
                        color_equivariant=False)
    env = answer_given_env(n_tasks=2, h=5, w=5, colors=6, seed=5)
    bs = env.reset(jax.random.key(5), 4)
    agent = answer_given_agent(model)
    obs = agent.obs_fn(bs.env)
    params = agent.init_fn(jax.random.key(6), obs)

    from arcle_tpu.benchmarks.answer_given import _unpack

    def fwd(params, obs):
        g, gd, a, ad = _unpack(obs, 5, 5)
        z = jnp.zeros((g.shape[0],), jnp.int8)
        return model.apply(params, g, gd, a, ad, z, z)

    perm = np.array([2, 0, 1, 5, 3, 4])
    inv = np.argsort(perm)
    out = fwd(params, obs)
    st = bs.env
    st_p = st.replace(
        grid=jnp.asarray(perm, jnp.int8)[st.grid.astype(jnp.int32)],
        answer=jnp.asarray(perm, jnp.int8)[st.answer.astype(jnp.int32)])
    params_p = jax.tree_util.tree_map_with_path(
        lambda path, x: x[jnp.asarray(inv)]
        if any(getattr(p, "key", None) == "color_encoder" for p in path)
        else x, params)
    out_p = fwd(params_p, agent.obs_fn(st_p))
    assert not np.allclose(np.asarray(out_p["op_logits"]),
                           np.asarray(out["op_logits"])[:, inv],
                           rtol=5e-3, atol=5e-3)


@pytest.mark.slow
def test_factorized_policy_shapes():
    """Non-sequential control: op-independent bbox head (identical rows
    across ops) and full-width op logits."""
    model = make_policy(h=5, w=5, colors=10, n_layer=2, n_head=2,
                        n_embd=32, factorized=True)
    env = answer_given_env(n_tasks=2, h=5, w=5, colors=10, seed=6)
    bs = env.reset(jax.random.key(7), 4)
    agent = answer_given_agent(model)
    obs = agent.obs_fn(bs.env)
    params = agent.init_fn(jax.random.key(8), obs)
    acts, lp, v = agent.sample_fn(params, obs, jax.random.key(9))
    assert acts.shape == (4, 5)
    assert np.all(np.asarray(acts[:, :4]) < 5)
    from arcle_tpu.benchmarks.answer_given import _unpack
    g, gd, a, ad = _unpack(obs, 5, 5)
    z = jnp.zeros((4,), jnp.int8)
    out = model.apply(params, g, gd, a, ad, z, z)
    bm = np.asarray(out["bbox_mean_all"])
    assert bm.shape == (4, 10, 4)
    assert np.all(bm == bm[:, :1, :])   # rows identical across ops


# ---------------------------------------------------------------------------
# End-to-end PPO mechanics (every aux ablation cell)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("aux", ["none", "rtm1", "rtm1+rt", "all"])
@pytest.mark.slow
def test_ppo_iteration_runs(aux):
    from arcle_tpu.training.train_answer_given import build, main  # noqa: F401
    import argparse

    class A(argparse.Namespace):
        pass

    args = A(setting="random", size=5, colors=4, n_tasks=8,
             episode_limit=8, arch="color_eq", aux=aux, aux_coeff=0.3,
             n_layer=1, n_head=2, n_embd=32, n_envs=8, rollout=8,
             lr=1e-3, gamma=0.99, gae_lambda=0.95, clip=0.2,
             vf_coeff=0.5, ent_coeff=0.01, epochs=1, minibatches=1,
             seed=0, bbox_dist="categorical" if aux != "rtm1"
             else "truncnorm", min_log_std=-2.3)
    env, agent, pcfg = build(args)
    from arcle_tpu.training.ppo import (
        batch_from_trajectory, make_optimizer, train_step)
    from arcle_tpu.training.rollout import rollout

    key = jax.random.key(0)
    key, ki, kr = jax.random.split(key, 3)
    bs = env.reset(kr, 8)
    params = agent.init_fn(ki, agent.obs_fn(
        jax.tree.map(lambda x: x[:1], bs.env)))
    tx = make_optimizer(pcfg)
    opt = tx.init(params)
    bs, traj, last_v = rollout(env, bs, params, key, 8, agent)
    batch = batch_from_trajectory(traj, last_v, pcfg,
                                  include_aux=(aux != "none"),
                                  grid_slice=slice(0, 25))
    p2, opt2, stats = train_step(params, opt, batch, key, agent, tx, pcfg)
    assert np.isfinite(float(stats["total_loss"]))
    if aux != "none":
        assert np.isfinite(float(stats["aux_loss"]))
        # aux gradients flow: at least one param moved in the aux heads
        def leafdiff(a, b):
            return sum(float(jnp.abs(x - y).sum())
                       for x, y in zip(jax.tree.leaves(a),
                                       jax.tree.leaves(b)))
        assert leafdiff(p2, params) > 0.0
    # rewards in the paper's [-1, 0] band
    assert float(traj.rewards.max()) <= 0.0
    assert float(traj.rewards.min()) >= -1.0


@pytest.mark.slow
def test_sequential_policy_two_pass():
    """§4.1.2 arch (2): selection conditioned on the sampled operation via
    a second forward.  Sampled log-probs must equal evaluate_fn's
    recomputation at the stored action (PPO ratio 1 at epoch 0)."""
    model = make_policy(h=5, w=5, colors=6, n_layer=1, n_head=2, n_embd=32,
                        color_equivariant=False)
    env = answer_given_env(n_tasks=2, h=5, w=5, colors=6, seed=8)
    bs = env.reset(jax.random.key(11), 8)
    agent = answer_given_agent(model, sequential=True)
    obs = agent.obs_fn(bs.env)
    params = agent.init_fn(jax.random.key(12), obs)
    acts, lp, v = agent.sample_fn(params, obs, jax.random.key(13))
    lp2, v2, ent = agent.evaluate_fn(params, obs, acts)
    np.testing.assert_allclose(np.asarray(lp), np.asarray(lp2),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(v), np.asarray(v2), rtol=1e-5)
    # the selection distribution must actually depend on the op: swap the
    # op of the stored action and check the bbox log-prob changes for at
    # least some rows (it reads a different conditioned pass)
    acts2 = np.asarray(acts).copy()
    acts2[:, 4] = (acts2[:, 4] + 1) % 6
    lp3, _, _ = agent.evaluate_fn(params, obs, jnp.asarray(acts2))
    assert not np.allclose(np.asarray(lp3), np.asarray(lp2))


def test_categorical_bbox_dist_consistency():
    """The sampled log-prob equals the recomputed log-prob of the stored
    integer action (PPO ratios start at exactly 1), and entropy is the
    sum of the op + 4 coordinate categorical entropies."""
    from arcle_tpu.models import bbox_dist as bd
    rng = jax.random.key(0)
    B, n_ops, bins = 16, 10, 5
    k1, k2, k3 = jax.random.split(rng, 3)
    op_logits = jax.random.normal(k1, (B, n_ops))
    bl = jax.random.normal(k2, (B, n_ops, 4, bins))
    s = bd.sample_categorical(k3, op_logits, bl)
    lp2 = bd.log_prob_categorical(op_logits, bl, s.operation, s.bbox)
    np.testing.assert_allclose(np.asarray(s.log_prob), np.asarray(lp2),
                               rtol=1e-5, atol=1e-5)
    ent = bd.entropy_categorical(op_logits, bl, s.operation)
    assert ent.shape == (B,)
    # bounded by log of the joint support
    assert np.all(np.asarray(ent) <= np.log(n_ops) + 4 * np.log(bins) + 1e-5)
    assert np.all(np.asarray(ent) > 0)
    # deterministic mode = argmax everywhere
    sd = bd.sample_categorical(k3, op_logits, bl, deterministic=True)
    np.testing.assert_array_equal(np.asarray(sd.operation),
                                  np.asarray(jnp.argmax(op_logits, -1)))


def test_answer_obs_layout():
    env = answer_given_env(n_tasks=2, h=5, w=5, colors=10, seed=7)
    bs = env.reset(jax.random.key(10), 2)
    obs = answer_obs(bs.env)
    assert obs.shape == (2, 54)
    np.testing.assert_array_equal(
        np.asarray(obs[:, :25].reshape(2, 5, 5)).astype(np.int8),
        np.asarray(bs.env.grid))
    np.testing.assert_array_equal(
        np.asarray(obs[:, 27:52].reshape(2, 5, 5)).astype(np.int8),
        np.asarray(bs.env.answer))


# ---------------------------------------------------------------------------
# ARC setting (paper Fig. 5 left panel) and continual setting (Fig. 7)
# ---------------------------------------------------------------------------
def test_small_arc_loader_shape_preserving():
    """The ARC-setting task distribution keeps only shape-preserving
    pairs (Color ops cannot change grid dims) and respects the <=5x5
    envelope of the paper's filtered ARC subset."""
    from arcle_tpu.benchmarks.answer_given import small_arc_loader
    loader = small_arc_loader(n_tasks=32, max_size=5, colors=10, seed=3)
    tasks = loader.parse()
    assert len(tasks) == 32
    for ti, to, ei, eo, _desc in tasks:
        for i, o in zip(ti + ei, to + eo):
            assert i.shape == o.shape
            assert max(i.shape) <= 5
            assert i.min() >= 0 and i.max() < 10


def test_arc_setting_env():
    """--setting arc wires the filtered loader into the answer-given env:
    every reset pair has grid_dim == answer_dim (solvable under Color
    ops), rewards stay in the paper's [-1, 0] band."""
    env = answer_given_env(n_tasks=16, setting="arc", seed=1,
                           episode_limit=8)
    bs = env.reset(jax.random.key(0), 8)
    np.testing.assert_array_equal(np.asarray(bs.env.grid_dim),
                                  np.asarray(bs.env.answer_dim))
    sel = np.zeros((8, 5, 5), np.int8)
    sel[:, 0, 0] = 1
    _, _, rew, term, _ = env.step(
        bs, Action(selection=jnp.asarray(sel),
                   operation=jnp.zeros((8,), jnp.int32)))
    r = np.asarray(rew)
    assert np.all(r <= 0.0) and np.all(r >= -1.0)

    # the match/termination path on ARC-setting dims (< 5x5 allowed):
    # hand the env a state whose grid already equals its answer outside
    # one wrong cell, fix that cell, and require reward 0 + terminated
    import dataclasses as _dc
    env_nr = _dc.replace(env, auto_reset=False)
    bs = env.reset(jax.random.key(3), 8)
    g = np.asarray(bs.env.answer).copy()
    ad = np.asarray(bs.env.answer_dim)
    wrong_color = (g[:, 0, 0] + 1) % 10
    g[:, 0, 0] = wrong_color
    bs = _dc.replace(bs, env=_dc.replace(
        bs.env, grid=jnp.asarray(g),
        grid_dim=jnp.asarray(ad)))
    fix_sel = np.zeros((8, 5, 5), np.int8)
    fix_sel[:, 0, 0] = 1
    correct = np.asarray(bs.env.answer)[:, 0, 0].astype(np.int32)
    _, _, rew, term, _ = env_nr.step(
        bs, Action(selection=jnp.asarray(fix_sel),
                   operation=jnp.asarray(correct)))
    np.testing.assert_allclose(np.asarray(rew), 0.0)
    assert np.all(np.asarray(term))


def test_shaping_potential_matches_pixel_reward():
    """The driver's shaping potential phi(s) must equal pixel_reward(s)
    cell-for-cell — including on ARC-setting states with dims < 5x5 —
    or the shaping stops being potential-based (round-3 ARC regression)."""
    from arcle_tpu.benchmarks.answer_given import (
        answer_obs, shaping_potential)
    from arcle_tpu.ops.table import pixel_reward

    env = answer_given_env(n_tasks=32, setting="arc", seed=7,
                           episode_limit=8)
    bs = env.reset(jax.random.key(5), 16)
    # scribble on the grids so phi sees nontrivial wrongness, including
    # cells OUTSIDE answer_dim (which pixel_reward must ignore)
    rng = np.random.default_rng(0)
    g = np.asarray(bs.env.grid).copy()
    g[:, :, :] = rng.integers(0, 10, g.shape).astype(np.int8)
    import dataclasses as _dc
    st = _dc.replace(bs.env, grid=jnp.asarray(g))
    phi = np.asarray(shaping_potential(answer_obs(st), 5, 5))
    ref = np.asarray(jax.vmap(pixel_reward)(st))
    np.testing.assert_allclose(phi, ref, atol=1e-6)
    # dims < 5x5 must actually occur in this fixture or the test is void
    assert (np.asarray(st.answer_dim).prod(axis=-1) < 25).any()


@pytest.mark.slow
def test_continual_phase_banks_shape_stable():
    """§4.1.3 continual setting: the five phase banks (2/4/6/8/10 colors)
    are shape- and dtype-identical pytrees, so the driver's
    dataclasses.replace(env, bank=...) phase switch recompiles nothing;
    each bank's colors stay within its phase palette."""
    banks = [RandomPairLoader(16, 5, 5, c, seed=100 + c).bank(H=5, W=5)
             for c in (2, 4, 6, 8, 10)]
    ref = jax.tree.map(lambda x: (x.shape, x.dtype), banks[0])
    for b, c in zip(banks, (2, 4, 6, 8, 10)):
        assert jax.tree.map(lambda x: (x.shape, x.dtype), b) == ref
        assert int(jnp.max(b.in_grids)) < c
        assert int(jnp.max(b.out_grids)) < c

    env = answer_given_env(n_tasks=16, h=5, w=5, colors=2, seed=0)
    bs = env.reset(jax.random.key(1), 4)
    sel = jnp.asarray(np.eye(5, dtype=np.int8)[None, :, :].repeat(4, 0))
    act = Action(selection=sel, operation=jnp.zeros((4,), jnp.int32))
    for b in banks[1:]:
        env = dataclasses.replace(env, bank=b)
        bs = env.reset(jax.random.key(2), 4)
        _, _, rew, _, _ = env.step(bs, act)
        assert np.all(np.asarray(rew) <= 0.0)
