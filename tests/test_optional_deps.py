"""The main path without the optional packages: the plain-JAX MLP policy
against a NumPy reference, and a training run with flax, gymnasium and
orbax unimportable."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from arcle_tpu.models.mlp import FCPolicy, fc_policy_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fc_policy_tree_and_numpy_reference():
    policy = FCPolicy(hidden=(64, 32, 16), n_ops=35)
    obs = jnp.asarray(np.random.default_rng(0).integers(
        -5, 10, (6, 2710)), jnp.int8)
    params = policy.init(jax.random.key(0), obs[:1])
    shapes = jax.tree.map(lambda x: x.shape, params["params"])
    assert shapes == {
        "fc_0": {"kernel": (2710, 64), "bias": (64,)},
        "fc_1": {"kernel": (64, 32), "bias": (32,)},
        "fc_2": {"kernel": (32, 16), "bias": (16,)},
        "pi": {"kernel": (16, 155), "bias": (155,)},
        "vf": {"kernel": (16, 1), "bias": (1,)},
    }
    # flax Dense initialisers: zero biases, orthogonal heads
    assert all(not np.any(np.asarray(layer["bias"]))
               for layer in params["params"].values())
    w = np.asarray(params["params"]["vf"]["kernel"])
    np.testing.assert_allclose(np.linalg.norm(w), 1.0, rtol=1e-5)
    logits, value = policy.apply(params, obs)
    assert [x.shape for x in logits] == [(6, 30)] * 4 + [(6, 35)]
    ref_logits, ref_value = fc_policy_reference(params, np.asarray(obs))
    got = np.concatenate([np.asarray(x) for x in logits], -1)
    scale = np.abs(ref_logits).max()
    assert np.abs(got - ref_logits).max() <= 1e-5 * scale
    assert np.abs(np.asarray(value) - ref_value).max() <= \
        1e-5 * np.abs(ref_value).max()


BLOCKED_RUN = """
import sys
for name in ("flax", "gymnasium", "orbax"):
    sys.modules[name] = None          # any import of them raises
import arcle_tpu
from arcle_tpu.training import train
train.main(["--algo", "ppo", "--smoke", "--iterations", "1",
            "--ckpt-dir", sys.argv[1], "--log-file", sys.argv[2]])
for name in ("flax", "gymnasium", "orbax"):
    assert sys.modules[name] is None, name
print("TRAINED")
"""


def test_main_path_runs_without_flax_gymnasium_orbax(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"),
               PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, str(tmp_path / "ck"),
         str(tmp_path / "log.jsonl")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "TRAINED" in out.stdout
    assert os.listdir(tmp_path / "ck") == ["step_0.npz"]
