"""Roofline accounting: bytes/step and FLOPs/step next to steps/s.

Answers "is N steps/s good?" by putting the measured rate against the
card's peak memory bandwidth and bf16 tensor-core throughput.  The bytes
and FLOPs come from XLA's own cost model of the compiled program
(``cost_from_compiled``: ``flops`` / ``bytes accessed``).

Peaks are keyed by ``device_kind`` (the name JAX reports) and carry their
source.  A device that is not in the table is an error, not a default:
a share of a guessed peak is no measurement.  The published peaks assume
the card's full power limit, so every share is reported beside the
card's name and power limit as ``nvidia-smi`` reads them.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional

# per-device peaks: dense bf16 tensor-core TFLOP/s, device-memory GB/s
PEAKS: Dict[str, Dict[str, object]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0, "hbm_gbps": 3350.0,
        "source": "NVIDIA H100 data sheet, SXM5, dense (no sparsity), "
                  "at the 700 W power limit",
    },
}


def device_peaks(device=None) -> Dict[str, object]:
    """Peaks of ``device`` (default: the first JAX device); raises
    KeyError for a device kind the table does not hold."""
    if device is None:
        import jax
        device = jax.devices()[0]
    kind = getattr(device, "device_kind", "") or device.platform
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"add a row to roofline.PEAKS with its source")
    return dict(PEAKS[kind], kind=kind)


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, one line each
    (what every measured share is reported beside)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cost_from_compiled(compiled) -> Optional[Dict[str, float]]:
    """(flops, bytes accessed) from XLA's cost analysis of a compiled
    program; None when the backend doesn't expose it."""
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else None
    if not ca:
        return None
    return {"flops": float(ca.get("flops", 0.0)),
            "bytes": float(ca.get("bytes accessed", 0.0))}


def summarize(rate_steps_per_s: float, batch: int, steps: int,
              cost: Optional[Dict[str, float]], kind: str,
              card: str = "") -> Dict[str, object]:
    """Utilization block for a measured rollout rate on a device of
    ``kind`` (a ``PEAKS`` key).

    ``cost`` is the whole-rollout XLA cost analysis (``steps`` env
    steps at ``batch`` envs); rates are normalized per env-step.
    ``card`` is the card's name and power limit as ``nvidia-smi`` reads
    them, written beside the shares."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}")
    peaks = PEAKS[kind]
    out: Dict[str, object] = {"device_kind": kind, "card": card,
                              "peaks_source": peaks["source"]}
    n_env_steps = batch * steps
    if cost and cost["bytes"] > 0:
        bytes_per_step = cost["bytes"] / n_env_steps
        out["xla_bytes_per_env_step"] = round(bytes_per_step, 1)
        out["hbm_util_pct"] = round(
            100.0 * bytes_per_step * rate_steps_per_s
            / (peaks["hbm_gbps"] * 1e9), 2)
    if cost and cost["flops"] > 0:
        flops_per_step = cost["flops"] / n_env_steps
        out["xla_flops_per_env_step"] = round(flops_per_step, 1)
        out["mfu_pct"] = round(
            100.0 * flops_per_step * rate_steps_per_s
            / (peaks["bf16_tflops"] * 1e12), 3)
    return out
