"""Multi-host (multi-process) sharded stepping via jax.distributed:
2 CPU processes x 4 virtual devices must produce the exact rollout
checksum of a single 8-device process (SURVEY §4: 'multi-host tests via
jax.distributed with CPU fakes')."""

import os
import re
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # compile-heavy tier


_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _clean_env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


def _checksum(out: str):
    m = re.findall(r"CHECKSUM proc=(\d+) nproc=(\d+) value=(-?\d+)", out)
    return {int(p): int(v) for p, _n, v in m}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_rollout_matches_single_process():
    env = _clean_env()
    single = subprocess.run(
        [sys.executable, _WORKER, "0", "1", "0"], env=env,
        capture_output=True, text=True, timeout=420)
    assert single.returncode == 0, single.stderr[-2000:]
    ref = _checksum(single.stdout)[0]

    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(pid), "2", port], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
    chks = {}
    for so, _ in outs:
        chks.update(_checksum(so))
    assert chks[0] == chks[1] == ref, (chks, ref)


def test_missing_process_detected_at_init():
    """Failure story (VERDICT r1 missing #10 / reference healthy_worker_ids):
    a process expecting a 2-host job whose peer never starts must fail
    fast with a clear error, not hang forever."""
    env = _clean_env()
    port = str(_free_port())
    code = (
        "import os\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "from arcle_tpu.parallel import init_multihost, MultihostInitTimeout\n"
        "try:\n"
        f"    init_multihost('127.0.0.1:{port}', num_processes=2,\n"
        "                    process_id=0, timeout_s=8.0)\n"
        "except MultihostInitTimeout as e:\n"
        "    assert 'Restart the WHOLE job' in str(e)\n"
        "    print('DETECTED')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "DETECTED" in out.stdout, out.stdout

