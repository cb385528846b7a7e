"""Training stack: rollout, GAE, PPO update, E-MAML step, models."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from arcle_tpu.envs import BatchedEnv, ResetOptions
from arcle_tpu.loaders import SyntheticLoader
from arcle_tpu.ops import o2arc_table
from arcle_tpu.models import (
    FCPolicy, GPTPolicy, GPTConfig, TruncatedNormal, bbox_dist,
    HyperMLP,
)
from arcle_tpu.training import (
    rollout, gae, PPOConfig, batch_from_trajectory, ppo_loss,
    make_optimizer, train_step, EMAMLConfig, init_emaml, emaml_train_step,
    sample_task_assignment, mlp_agent, gpt_agent,
)
from arcle_tpu.wrappers import flatten_obs

pytestmark = pytest.mark.slow  # compile-heavy tier


OBS_DIM = 2710  # FilterO2ARC flattened width (3*900 + 4*2 + 2*1)


def small_policy():
    return FCPolicy(hidden=(64, 64), n_ops=35)


def make_env(auto=True, limit=20):
    return BatchedEnv(table=o2arc_table(max_trial=3),
                      bank=SyntheticLoader(6, seed=0).bank(), max_trial=3,
                      episode_limit=limit, auto_reset=auto)


def test_flatten_obs_width():
    env = make_env()
    bs = env.reset(jax.random.key(0), 4)
    flat = flatten_obs(bs.env)
    assert flat.shape == (4, OBS_DIM)


def test_rollout_shapes_and_gae():
    env = make_env()
    B, T = 8, 12
    agent = mlp_agent(small_policy())
    bs = env.reset(jax.random.key(0), B)
    params = agent.init_fn(jax.random.key(1), flatten_obs(bs.env))
    bs, traj, last_v = jax.jit(
        rollout, static_argnums=(4, 5, 6))(env, bs, params,
                                           jax.random.key(2), T, agent)
    assert traj.obs.shape == (T, B, OBS_DIM)
    assert traj.actions.shape == (T, B, 5)
    assert traj.rewards.shape == (T, B)
    adv, ret = gae(traj, last_v, 0.9, 0.95)
    assert adv.shape == (T, B)
    assert np.isfinite(np.asarray(adv)).all()


def test_gae_against_reference_formula():
    """Closed-form check on a hand-built no-done trajectory."""
    from arcle_tpu.training.rollout import Trajectory
    T, B = 4, 1
    vals = jnp.asarray([[1.], [2.], [3.], [4.]])
    rews = jnp.asarray([[1.], [1.], [1.], [1.]])
    zeros = jnp.zeros((T, B), bool)
    traj = Trajectory(obs=jnp.zeros((T, B, 1)), actions=jnp.zeros((T, B, 5), jnp.int32),
                      log_probs=jnp.zeros((T, B)), values=vals, rewards=rews,
                      dones=zeros, terminated=zeros,
                      final_values=jnp.zeros((T, B)))
    gamma, lam = 0.9, 0.8
    adv, ret = gae(traj, jnp.asarray([5.]), gamma, lam)
    # manual backward recursion
    expect = np.zeros((T, 1))
    nxt = 0.0
    v_next = 5.0
    for t in reversed(range(T)):
        delta = 1.0 + gamma * v_next - float(vals[t, 0])
        nxt = delta + gamma * lam * nxt
        expect[t, 0] = nxt
        v_next = float(vals[t, 0])
    np.testing.assert_allclose(np.asarray(adv), expect, rtol=1e-5)


def test_gae_truncation_bootstrap():
    """TimeLimit semantics (emaml_policy.py:449-460): a truncated-but-not-
    terminated boundary bootstraps its delta with V(pre-reset obs); a true
    termination bootstraps 0; both cut the advantage chain."""
    from arcle_tpu.training.rollout import Trajectory
    T, B = 5, 1
    vals = jnp.asarray([[1.], [2.], [3.], [4.], [5.]])
    rews = jnp.asarray([[1.], [1.], [1.], [1.], [1.]])
    # t=1: truncation with final value 7; t=3: true termination
    dones = jnp.asarray([[0.], [1.], [0.], [1.], [0.]], bool)
    term = jnp.asarray([[0.], [0.], [0.], [1.], [0.]], bool)
    fvals = jnp.asarray([[0.], [7.], [0.], [0.], [0.]])
    traj = Trajectory(obs=jnp.zeros((T, B, 1)),
                      actions=jnp.zeros((T, B, 5), jnp.int32),
                      log_probs=jnp.zeros((T, B)), values=vals, rewards=rews,
                      dones=dones, terminated=term, final_values=fvals)
    gamma, lam = 0.9, 0.8
    last_v = jnp.asarray([6.])
    adv, ret = gae(traj, last_v, gamma, lam, bootstrap_truncation=True)
    expect = np.zeros((T, 1))
    nxt = 0.0
    v_next = 6.0
    for t in reversed(range(T)):
        d = float(dones[t, 0])
        boot = float(fvals[t, 0])          # nonzero only at the truncation
        delta = 1.0 + gamma * (v_next * (1 - d) + boot) - float(vals[t, 0])
        nxt = delta + gamma * lam * (1 - d) * nxt
        expect[t, 0] = nxt
        v_next = float(vals[t, 0])
    np.testing.assert_allclose(np.asarray(adv), expect, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ret), expect + np.asarray(vals),
                               rtol=1e-5)
    # legacy mode ignores final_values entirely
    adv0, _ = gae(traj, last_v, gamma, lam, bootstrap_truncation=False)
    assert abs(float(adv0[1, 0]) - (1.0 - 2.0 + gamma * 7.0)) > 1.0


def test_rollout_final_values_only_at_truncation():
    """final_values is nonzero exactly where truncated & ~terminated, and
    equals the value head applied to the pre-reset observation."""
    env = make_env(limit=4)
    B, T = 8, 9
    agent = mlp_agent(small_policy())
    bs = env.reset(jax.random.key(0), B)
    params = agent.init_fn(jax.random.key(1), flatten_obs(bs.env))
    bs, traj, last_v = rollout(env, bs, params, jax.random.key(2), T, agent)
    fv = np.asarray(traj.final_values)
    need = np.asarray(traj.dones & ~traj.terminated)
    assert need.any()                      # limit=4 forces truncations
    assert (fv[~need] == 0).all()
    assert np.isfinite(fv).all()
    # at least one bootstrap value should be a real (nonzero) value-head out
    assert np.abs(fv[need]).max() > 0


def test_ppo_train_step_improves_loss():
    env = make_env()
    B, T = 16, 20
    agent = mlp_agent(small_policy())
    cfg = PPOConfig(n_epochs=2, n_minibatches=2, lr=1e-3)
    bs = env.reset(jax.random.key(0), B)
    params = agent.init_fn(jax.random.key(1), flatten_obs(bs.env))
    tx = make_optimizer(cfg)
    opt_state = tx.init(params)
    bs, traj, last_v = rollout(env, bs, params, jax.random.key(2), T, agent)
    batch = batch_from_trajectory(traj, last_v, cfg)
    loss0, _ = ppo_loss(params, agent, batch, cfg)
    params2, opt_state, stats = jax.jit(
        train_step, static_argnums=(4, 5, 6))(params, opt_state, batch,
                                              jax.random.key(3), agent,
                                              tx, cfg)
    loss1, _ = ppo_loss(params2, agent, batch, cfg)
    assert np.isfinite(float(loss1))
    assert float(loss1) < float(loss0)  # optimizing the same batch must help


def test_emaml_step_runs_and_updates():
    cfg = EMAMLConfig(n_tasks=2, envs_per_task=3, rollout_steps=6,
                      inner_steps=2, maml_opt_steps=1,
                      ppo=PPOConfig())
    agent = mlp_agent(small_policy())
    bank = SyntheticLoader(5, seed=1).bank()
    key = jax.random.key(0)
    assign = sample_task_assignment(jax.random.key(5), 5, cfg)
    assert assign.shape == (cfg.n_tasks * cfg.envs_per_task,)
    opts = ResetOptions(
        prob_index=assign, subprob_index=jnp.full_like(assign, -1),
        adaptation=jnp.ones((), bool), reset_on_submit=jnp.zeros((), bool))
    env = BatchedEnv(table=o2arc_table(max_trial=3), bank=bank, max_trial=3,
                     episode_limit=6, auto_reset=True, opts=opts)
    bs = env.reset(jax.random.key(1), cfg.n_tasks * cfg.envs_per_task)
    # envs are pinned to their assigned tasks (pin the pair too to check)
    opts_pinned = ResetOptions(
        prob_index=assign, subprob_index=jnp.zeros_like(assign),
        adaptation=jnp.ones((), bool), reset_on_submit=jnp.zeros((), bool))
    env_pinned = BatchedEnv(table=o2arc_table(max_trial=3), bank=bank,
                            max_trial=3, opts=opts_pinned)
    bsp = env_pinned.reset(jax.random.key(1),
                           cfg.n_tasks * cfg.envs_per_task)
    dims = np.asarray(bsp.env.input_dim).reshape(cfg.n_tasks,
                                                 cfg.envs_per_task, 2)
    for tt in range(cfg.n_tasks):
        assert (dims[tt] == dims[tt][0]).all()

    st = init_emaml(agent, cfg, key, n_bank_tasks=5)
    st2, bs2, metrics = jax.jit(
        emaml_train_step, static_argnums=(3, 4))(st, env, bs, agent, cfg)
    assert np.isfinite(float(metrics["meta_loss"]))
    changed = jax.tree.map(
        lambda a, b: not np.array_equal(np.asarray(a), np.asarray(b)),
        st.params, st2.params)
    assert any(jax.tree.leaves(changed))
    assert metrics["post_reward_per_task"].shape == (cfg.n_tasks,)
    # success bookkeeping (emaml.py:431-454): each sampled task counted once
    np.testing.assert_array_equal(
        np.asarray(metrics["sampled_tasks"]),
        np.asarray(assign).reshape(cfg.n_tasks, cfg.envs_per_task)[:, 0])
    assert int(st2.tasks_covered.sum()) == cfg.n_tasks
    assert int(metrics["num_covered_tasks"]) == cfg.n_tasks  # w/o replacement
    assert metrics["once_successful"].shape == (cfg.n_tasks,)
    assert int(st2.tasks_succeeded.sum()) == int(
        metrics["once_successful"].sum())
    # outer loss components present (wandb schema, train.py:130-150)
    for k in ("outer_policy_loss", "outer_vf_loss", "outer_kl_loss",
              "outer_total_loss"):
        assert np.isfinite(float(metrics[k]))
    # the persisted post batch covers every task
    assert metrics["post_batch"].obs.shape[0] == cfg.n_tasks


def test_emaml_with_gpt_agent():
    """gpt_agent runs through the full emaml_train_step (inner loop, meta
    replay, KL ladder) — CI-scale version of the train_gpt E-MAML path."""
    cfg = EMAMLConfig(n_tasks=2, envs_per_task=2, rollout_steps=4,
                      inner_steps=1, maml_opt_steps=1, first_order=True)
    gcfg = GPTConfig(n_layer=1, n_head=2, n_embd=16, embd_pdrop=0.0,
                     resid_pdrop=0.0, attn_pdrop=0.0)
    agent = gpt_agent(GPTPolicy(gcfg))
    bank = SyntheticLoader(4, seed=2).bank()
    assign = sample_task_assignment(jax.random.key(5), 4, cfg)
    opts = ResetOptions(
        prob_index=assign, subprob_index=jnp.full_like(assign, -1),
        adaptation=jnp.ones((), bool), reset_on_submit=jnp.zeros((), bool))
    env = BatchedEnv(table=o2arc_table(max_trial=3), bank=bank, max_trial=3,
                     episode_limit=4, auto_reset=True, opts=opts)
    bs = env.reset(jax.random.key(1), cfg.n_tasks * cfg.envs_per_task)
    st = init_emaml(agent, cfg, jax.random.key(0), n_bank_tasks=4)
    st2, bs2, metrics = jax.jit(
        emaml_train_step, static_argnums=(3, 4))(st, env, bs, agent, cfg)
    assert np.isfinite(float(metrics["meta_loss"]))
    changed = jax.tree.map(
        lambda a, b: not np.array_equal(np.asarray(a), np.asarray(b)),
        st.params, st2.params)
    assert any(jax.tree.leaves(changed))


def test_truncated_normal_matches_reference_torch():
    """Sample/statistics sanity + log_prob vs torch reference impl."""
    tn = TruncatedNormal.create(jnp.asarray([0.3, 0.9]),
                                jnp.asarray([0.2, 0.5]), 0.0, 1.0)
    s = tn.sample(jax.random.key(0), (2000,))
    assert float(s.min()) >= 0.0 and float(s.max()) <= 1.0
    lp = tn.log_prob(jnp.asarray([0.3, 0.5]))
    assert np.isfinite(np.asarray(lp)).all()
    # cross-check against scipy truncnorm
    from scipy.stats import truncnorm
    a = (0 - 0.3) / 0.2
    b = (1 - 0.3) / 0.2
    np.testing.assert_allclose(
        float(lp[0]), truncnorm.logpdf(0.3, a, b, loc=0.3, scale=0.2),
        rtol=1e-4)


def test_bbox_dist_roundtrip():
    key = jax.random.key(0)
    B, n_ops = 4, 35
    logits = jax.random.normal(key, (B, n_ops))
    mean_all = jax.random.normal(jax.random.key(1), (B, n_ops, 4)) * 0.1
    std_all = jax.random.normal(jax.random.key(2), (B, n_ops, 4)) * 0.1
    s = bbox_dist.sample(key, logits, mean_all, std_all)
    assert s.bbox.shape == (B, 4)
    assert (np.asarray(s.bbox) >= 0).all() and (np.asarray(s.bbox) < 30).all()
    lp = bbox_dist.log_prob(logits, mean_all, std_all, s.operation, s.bbox)
    assert np.isfinite(np.asarray(lp)).all()
    ent = bbox_dist.entropy(logits, mean_all, std_all, s.operation)
    assert np.isfinite(np.asarray(ent)).all()
    # select_op is the gather it replaces
    np.testing.assert_allclose(
        np.asarray(bbox_dist.select_op(mean_all, s.operation)),
        np.asarray(jnp.take_along_axis(
            mean_all, s.operation[:, None, None], axis=1).squeeze(1)),
        rtol=1e-6)
    # deterministic mode: argmax op, mean bbox
    sd = bbox_dist.sample(key, logits, mean_all, std_all, deterministic=True)
    np.testing.assert_array_equal(np.asarray(sd.operation),
                                  np.asarray(jnp.argmax(logits, -1)))


def test_gpt_policy_forward():
    cfg = GPTConfig(n_layer=2, n_head=4, n_embd=32)
    model = GPTPolicy(cfg)
    B = 2
    env = make_env()
    bs = env.reset(jax.random.key(0), B)
    s = bs.env
    params = model.init(jax.random.key(1), s.grid, s.grid_dim, s.input,
                        s.input_dim, s.trials_remain, s.active)
    out = jax.jit(lambda p, *a: model.apply(p, *a))(
        params, s.grid, s.grid_dim, s.input, s.input_dim,
        s.trials_remain, s.active)
    assert out["op_logits"].shape == (B, 35)
    assert out["op_tokens"].shape == (B, 35, 32)
    assert out["value"].shape == (B,)
    assert out["aux_transition"].shape == (B, 900, 10)
    assert np.isfinite(np.asarray(out["op_logits"])).all()


def test_gpt_action_conditioned_pass():
    """The second, action-conditioned forward (GPTPolicy.py:401-456
    intent): appended op/bbox tokens change the aux predictions but the
    policy heads' token slots stay put."""
    cfg = GPTConfig(n_layer=2, n_head=4, n_embd=32,
                    embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    model = GPTPolicy(cfg)
    B = 3
    env = make_env()
    bs = env.reset(jax.random.key(0), B)
    s = bs.env
    params = model.init(jax.random.key(1), s.grid, s.grid_dim, s.input,
                        s.input_dim, s.trials_remain, s.active)
    base = model.apply(params, s.grid, s.grid_dim, s.input, s.input_dim,
                       s.trials_remain, s.active)
    op = jnp.asarray([3, 24, 34])
    bb = jnp.asarray([[0.1, 0.2, 0.5, 0.9]] * B)
    cond = model.apply(params, s.grid, s.grid_dim, s.input, s.input_dim,
                       s.trials_remain, s.active, operation=op, bbox=bb)
    # aux heads are now action-conditioned (values actually change)
    assert not np.allclose(np.asarray(cond["aux_reward"]),
                           np.asarray(base["aux_reward"]))
    assert not np.allclose(np.asarray(cond["aux_transition"]),
                           np.asarray(base["aux_transition"]))
    # different actions give different predictions
    cond2 = model.apply(params, s.grid, s.grid_dim, s.input, s.input_dim,
                        s.trials_remain, s.active,
                        operation=jnp.asarray([10, 10, 10]), bbox=bb * 0.5)
    assert not np.allclose(np.asarray(cond2["aux_reward"]),
                           np.asarray(cond["aux_reward"]))
    assert cond["aux_transition"].shape == (B, 900, 10)
    assert cond["op_logits"].shape == (B, 35)


def test_gpt_aux_loss_gradients_flow():
    """aux_coeff > 0 wires the paper's 3 auxiliary losses through
    ppo_loss, and gradients reach the aux heads + bbox encoder."""
    from arcle_tpu.training.rollout import rollout as _rollout
    cfg = GPTConfig(n_layer=1, n_head=2, n_embd=16,
                    embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    agent = gpt_agent(GPTPolicy(cfg))
    env = make_env(limit=5)
    B, T = 4, 6
    bs = env.reset(jax.random.key(0), B)
    params = agent.init_fn(jax.random.key(1), agent.obs_fn(bs.env))
    bs, traj, last_v = _rollout(env, bs, params, jax.random.key(2), T,
                                agent)
    pcfg = PPOConfig(aux_coeff=0.5)
    batch = batch_from_trajectory(traj, last_v, pcfg, include_aux=True)
    assert batch.next_grid.shape == (T * B, 900)
    assert batch.aux_valid.shape == (T * B,)
    (loss, stats), grads = jax.value_and_grad(ppo_loss, has_aux=True)(
        params, agent, batch, pcfg)
    assert np.isfinite(float(loss))
    for k in ("aux_loss", "aux_rtm1_loss", "aux_r_loss", "aux_grid_loss"):
        assert np.isfinite(float(stats[k])), k
    g = grads["params"]
    for name in ("bbox_encoder", "head_aux_reward", "head_aux_transition",
                 "head_aux_rtm1"):
        leaves = jax.tree.leaves(g[name])
        assert any(float(jnp.abs(l).max()) > 0 for l in leaves), name
    # off by default: aux stats absent, loss has no aux term
    loss0, stats0 = ppo_loss(params, agent, batch, PPOConfig())
    assert "aux_loss" not in stats0


def test_dt_behavior_cloning_learns():
    """DTPolicy trains: behavior cloning on oracle golden traces reduces
    the action-prediction loss (the training loop the reference's
    under-construction DTPolicy never got)."""
    from arcle_tpu.validation import generate_golden_traces
    from arcle_tpu.training.dt_bc import dataset_from_traces, train_bc
    from arcle_tpu.models.dt import DTPolicy, DTConfig

    tasks, traces, infos = generate_golden_traces(n_traces=8, seed=11,
                                                  n_steps=10)
    batch = dataset_from_traces(tasks, traces, infos, T_max=10)
    assert batch.grids.shape[1] == 10
    assert float(batch.mask.sum()) > 0
    model = DTPolicy(DTConfig(n_layer=1, n_head=2, n_embd=32,
                              max_timesteps=10))
    params, losses = train_bc(model, batch, jax.random.key(0), n_steps=30,
                              lr=1e-3)
    assert np.isfinite(np.asarray(losses)).all()
    assert float(losses[-1]) < float(losses[0]) * 0.9


def test_hypermlp_forward():
    m = HyperMLP(widths=(32,), out=4)
    x = jnp.ones((3, 8))
    params = m.init(jax.random.key(0), x)
    y = m.apply(params, x)
    assert y.shape == (3, 4)


def test_emaml_micro_batching_matches_full_batch():
    """n_micro>1 must be numerically equivalent to the full-batch path
    (gradient accumulation is exact: every accumulated term is a mean)."""
    from arcle_tpu.envs.core import ResetOptions

    bank = SyntheticLoader(6, seed=2).bank()
    ag = mlp_agent(FCPolicy(hidden=(16,), n_ops=35))

    def run(n_micro):
        cfg = EMAMLConfig(n_tasks=2, envs_per_task=2, rollout_steps=8,
                          inner_steps=2, maml_opt_steps=2,
                          first_order=True, n_micro=n_micro)
        st = init_emaml(ag, cfg, jax.random.key(0), n_bank_tasks=6)
        assign = sample_task_assignment(jax.random.key(1), 6, cfg)
        opts = ResetOptions(prob_index=assign,
                            subprob_index=jnp.full_like(assign, -1),
                            adaptation=jnp.ones((), bool),
                            reset_on_submit=jnp.zeros((), bool))
        env = BatchedEnv(table=o2arc_table(7, crop_at_33=True), bank=bank,
                         max_trial=7, episode_limit=8, auto_reset=True,
                         dense_reward=True, augment=True, opts=opts,
                         reset_pool=4)
        bs = env.reset(jax.random.key(2), 4)
        st2, _bs2, m = jax.jit(emaml_train_step, static_argnums=(3, 4))(
            st, env, bs, ag, cfg)
        return st2, m

    st_a, m_a = run(1)
    st_b, m_b = run(2)
    la, lb = float(m_a["meta_loss"]), float(m_b["meta_loss"])
    assert np.isfinite(la) and abs(la - lb) < 1e-3 * max(1, abs(la))
    deltas = jax.tree.map(lambda a, b: float(jnp.abs(a - b).max()),
                          st_a.params, st_b.params)
    assert max(jax.tree.leaves(deltas)) < 1e-4


def test_emaml_chunked_matches_fused():
    """The host-chunked step (make_chunked_train_step, the GPT-scale path)
    must reproduce the fused emaml_train_step numerically: with
    first_order=True the FOMAML decomposition is exact, so params and
    every metric match up to float reassociation."""
    from arcle_tpu.envs.core import ResetOptions
    from arcle_tpu.training.emaml import make_chunked_train_step

    bank = SyntheticLoader(6, seed=2).bank()
    ag = mlp_agent(FCPolicy(hidden=(16,), n_ops=35))

    def run(chunked):
        cfg = EMAMLConfig(n_tasks=2, envs_per_task=2, rollout_steps=8,
                          inner_steps=3, maml_opt_steps=2,
                          first_order=True, chunked=chunked)
        st = init_emaml(ag, cfg, jax.random.key(0), n_bank_tasks=6)
        assign = sample_task_assignment(jax.random.key(1), 6, cfg)
        opts = ResetOptions(prob_index=assign,
                            subprob_index=jnp.full_like(assign, -1),
                            adaptation=jnp.ones((), bool),
                            reset_on_submit=jnp.zeros((), bool))
        env = BatchedEnv(table=o2arc_table(7, crop_at_33=True), bank=bank,
                         max_trial=7, episode_limit=8, auto_reset=True,
                         dense_reward=True, augment=True, opts=opts,
                         reset_pool=4)
        bs = env.reset(jax.random.key(2), 4)
        if chunked:
            st2, _bs2, m = make_chunked_train_step(ag, cfg)(st, env, bs)
        else:
            st2, _bs2, m = jax.jit(emaml_train_step, static_argnums=(3, 4))(
                st, env, bs, ag, cfg)
        return st2, m

    st_f, m_f = run(False)
    st_c, m_c = run(True)
    lf, lc = float(m_f["meta_loss"]), float(m_c["meta_loss"])
    assert abs(lf - lc) < 1e-4 * max(1, abs(lf)), (lf, lc)
    delta = max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(jnp.abs(a - b).max()), st_f.params, st_c.params)))
    assert delta < 1e-5, delta
    for k in ("inner_kl_mean", "post_eprew_mean", "adapt_reward_mean",
              "num_covered_tasks"):
        assert np.allclose(np.asarray(m_f[k]), np.asarray(m_c[k]),
                           atol=1e-5), k
    # RNG bookkeeping identical: same final key
    assert (jax.random.key_data(st_f.key)
            == jax.random.key_data(st_c.key)).all()


def test_chunked_requires_first_order():
    from arcle_tpu.training.emaml import make_chunked_train_step

    ag = mlp_agent(FCPolicy(hidden=(8,), n_ops=35))
    with pytest.raises(ValueError):
        make_chunked_train_step(ag, EMAMLConfig(first_order=False))


def test_emaml_chunked_with_gpt_agent():
    """gpt_agent through the host-chunked step with micro-batching — the
    production GPT-scale path (train_gpt.py non-smoke) at CI scale."""
    from arcle_tpu.training.emaml import make_chunked_train_step

    cfg = EMAMLConfig(n_tasks=2, envs_per_task=2, rollout_steps=4,
                      inner_steps=2, maml_opt_steps=2, first_order=True,
                      n_micro=2, chunked=True)
    gcfg = GPTConfig(n_layer=1, n_head=2, n_embd=16, embd_pdrop=0.0,
                     resid_pdrop=0.0, attn_pdrop=0.0)
    agent = gpt_agent(GPTPolicy(gcfg))
    bank = SyntheticLoader(4, seed=2).bank()
    assign = sample_task_assignment(jax.random.key(5), 4, cfg)
    opts = ResetOptions(
        prob_index=assign, subprob_index=jnp.full_like(assign, -1),
        adaptation=jnp.ones((), bool), reset_on_submit=jnp.zeros((), bool))
    env = BatchedEnv(table=o2arc_table(max_trial=3), bank=bank, max_trial=3,
                     episode_limit=4, auto_reset=True, opts=opts)
    bs = env.reset(jax.random.key(1), cfg.n_tasks * cfg.envs_per_task)
    st = init_emaml(agent, cfg, jax.random.key(0), n_bank_tasks=4)
    st2, bs2, metrics = make_chunked_train_step(agent, cfg)(st, env, bs)
    assert np.isfinite(float(metrics["meta_loss"]))
    changed = jax.tree.map(
        lambda a, b: not np.array_equal(np.asarray(a), np.asarray(b)),
        st.params, st2.params)
    assert any(jax.tree.leaves(changed))


def test_emaml_cached_chain_close_to_exact():
    """cache_chain replays the inner chain once and transports deltas
    through the later meta-opt steps (EMAMLConfig.cache_chain).  It is
    exact at maml_opt_steps=1 and a first-order approximation after —
    this measures both: bit-level agreement at 1 meta step, small
    relative parameter divergence at 2."""
    from arcle_tpu.envs.core import ResetOptions
    from arcle_tpu.training.emaml import make_chunked_train_step

    bank = SyntheticLoader(6, seed=2).bank()
    ag = mlp_agent(FCPolicy(hidden=(16,), n_ops=35))

    def run(cache, meta_steps):
        cfg = EMAMLConfig(n_tasks=2, envs_per_task=2, rollout_steps=8,
                          inner_steps=3, maml_opt_steps=meta_steps,
                          first_order=True, chunked=True,
                          cache_chain=cache)
        st = init_emaml(ag, cfg, jax.random.key(0), n_bank_tasks=6)
        assign = sample_task_assignment(jax.random.key(1), 6, cfg)
        opts = ResetOptions(prob_index=assign,
                            subprob_index=jnp.full_like(assign, -1),
                            adaptation=jnp.ones((), bool),
                            reset_on_submit=jnp.zeros((), bool))
        env = BatchedEnv(table=o2arc_table(7, crop_at_33=True), bank=bank,
                         max_trial=7, episode_limit=8, auto_reset=True,
                         dense_reward=True, augment=True, opts=opts,
                         reset_pool=4)
        bs = env.reset(jax.random.key(2), 4)
        st2, _bs2, m = make_chunked_train_step(ag, cfg)(st, env, bs)
        return st2, m

    # one meta-opt step: the cached path IS the exact path
    st_e1, m_e1 = run(False, 1)
    st_c1, m_c1 = run(True, 1)
    d1 = max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(jnp.abs(a - b).max()),
        st_e1.params, st_c1.params)))
    assert d1 < 1e-6, d1
    assert np.allclose(float(m_e1["meta_loss"]), float(m_c1["meta_loss"]),
                       atol=1e-6)

    # two meta-opt steps: divergence bounded by the first-order argument
    # (|delta params| ~ meta_lr per step -> relative error ~1e-3)
    st_e2, _ = run(False, 2)
    st_c2, _ = run(True, 2)
    num = max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(jnp.abs(a - b).max()),
        st_e2.params, st_c2.params)))
    scale = max(jax.tree.leaves(jax.tree.map(
        lambda a: float(jnp.abs(a).max()), st_e2.params)))
    assert num / scale < 5e-3, (num, scale)


def test_emaml_kl_ladder_fast_path_close():
    """kl_ladder_grads=False reads the ladder KLs off the surrogate pass
    and drops the ~coeff*kl gradient term (weight ~1e-7); params must
    stay within that perturbation of the exact path and the reported KLs
    must match to float tolerance."""
    from arcle_tpu.envs.core import ResetOptions
    from arcle_tpu.training.emaml import make_chunked_train_step

    bank = SyntheticLoader(6, seed=2).bank()
    ag = mlp_agent(FCPolicy(hidden=(16,), n_ops=35))

    def run(fast):
        cfg = EMAMLConfig(n_tasks=2, envs_per_task=2, rollout_steps=8,
                          inner_steps=3, maml_opt_steps=2,
                          first_order=True, chunked=True, cache_chain=True,
                          kl_ladder_grads=not fast, n_micro=2)
        st = init_emaml(ag, cfg, jax.random.key(0), n_bank_tasks=6)
        assign = sample_task_assignment(jax.random.key(1), 6, cfg)
        opts = ResetOptions(prob_index=assign,
                            subprob_index=jnp.full_like(assign, -1),
                            adaptation=jnp.ones((), bool),
                            reset_on_submit=jnp.zeros((), bool))
        env = BatchedEnv(table=o2arc_table(7, crop_at_33=True), bank=bank,
                         max_trial=7, episode_limit=8, auto_reset=True,
                         dense_reward=True, augment=True, opts=opts,
                         reset_pool=4)
        bs = env.reset(jax.random.key(2), 4)
        st2, _bs2, m = make_chunked_train_step(ag, cfg)(st, env, bs)
        return st2, m

    st_e, m_e = run(False)
    st_f, m_f = run(True)
    assert np.allclose(np.asarray(m_e["inner_kl_mean"]),
                       np.asarray(m_f["inner_kl_mean"]), atol=1e-5)
    num = max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(jnp.abs(a - b).max()), st_e.params,
        st_f.params)))
    scale = max(jax.tree.leaves(jax.tree.map(
        lambda a: float(jnp.abs(a).max()), st_e.params)))
    assert num / scale < 1e-3, (num, scale)


def test_gpt_dense_streaming_attention_equal():
    """The dense and streaming attention paths are the same exact softmax
    (GPTConfig.dense_attn_budget only picks the implementation)."""
    import dataclasses as dc
    B = 2
    base = GPTConfig(n_layer=1, n_head=2, n_embd=16, embd_pdrop=0.0,
                     resid_pdrop=0.0, attn_pdrop=0.0, grid_x=30,
                     grid_y=30, attn_chunk=256)
    key = jax.random.key(0)
    grid = jax.random.randint(jax.random.key(1), (B, 30, 30), 0, 10
                              ).astype(jnp.int8)
    dims = jnp.full((B, 2), 30, jnp.int8)
    tr = jnp.ones((B,), jnp.int8)
    ac = jnp.zeros((B,), jnp.int8)

    dense = GPTPolicy(dc.replace(base, dense_attn_budget=1 << 62))
    stream = GPTPolicy(dc.replace(base, dense_attn_budget=0))
    params = dense.init(key, grid, dims, grid, dims, tr, ac)
    od = dense.apply(params, grid, dims, grid, dims, tr, ac)
    os_ = stream.apply(params, grid, dims, grid, dims, tr, ac)
    for k in ("op_logits", "value"):
        np.testing.assert_allclose(np.asarray(od[k]), np.asarray(os_[k]),
                                   rtol=2e-2, atol=2e-3)
