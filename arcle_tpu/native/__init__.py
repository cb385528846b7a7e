"""Native (C++) host-side components, loaded via ctypes.

The compute path is JAX/XLA; these are the host-runtime pieces
(data baking) in C++ with lazy in-tree builds and pure-Python fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libbake.so")
_SRC = os.path.join(_DIR, "bake.cpp")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    """Build (once, lazily) and load the native baker; None on failure."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-o", _SO, _SRC],
                    check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(_SO)
            lib.bake_task.restype = ctypes.c_int
            lib.bake_task.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_int8),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
            _lib = lib
        except Exception:
            _build_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def bake_task_native(text: str, max_pairs: int = 256):
    """Parse one ARC task JSON with the C++ baker.

    Returns ``(train_pairs, test_pairs)`` where each pair is
    ``(input_grid, output_grid)`` of *unpadded* int8 arrays, or None if the
    native path is unavailable / the file doesn't parse.
    """
    lib = _load()
    if lib is None:
        return None
    raw = text.encode()
    grids = np.zeros((max_pairs, 2, 900), np.int8)
    dims = np.zeros((max_pairs, 2, 2), np.int32)
    splits = np.zeros((max_pairs,), np.int32)
    n = lib.bake_task(
        raw, len(raw),
        grids.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        splits.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_pairs)
    if n < 0:
        return None
    train, test = [], []
    for i in range(n):
        hi, wi = int(dims[i, 0, 0]), int(dims[i, 0, 1])
        ho, wo = int(dims[i, 1, 0]), int(dims[i, 1, 1])
        pair = (grids[i, 0].reshape(30, 30)[:hi, :wi].copy(),
                grids[i, 1].reshape(30, 30)[:ho, :wo].copy())
        (train if splits[i] == 0 else test).append(pair)
    return train, test


# ---------------------------------------------------------------------------
# Native single-env engine (engine.cpp) — the interactive B=1 hot path
# ---------------------------------------------------------------------------
_ESO = os.path.join(_DIR, "libengine.so")
_ESRC = os.path.join(_DIR, "engine.cpp")
_elib = None
_ebuild_failed = False

_MAXP = 900


class _CState(ctypes.Structure):
    """Mirror of ``NativeState`` in engine.cpp (field order/types must
    match exactly; sizeof is asserted against engine_state_size())."""

    _fields_ = [
        ("input", ctypes.c_int8 * _MAXP),
        ("grid", ctypes.c_int8 * _MAXP),
        ("selected", ctypes.c_int8 * _MAXP),
        ("clip", ctypes.c_int8 * _MAXP),
        ("object", ctypes.c_int8 * _MAXP),
        ("object_sel", ctypes.c_int8 * _MAXP),
        ("background", ctypes.c_int8 * _MAXP),
        ("answer", ctypes.c_int8 * _MAXP),
        ("input_dim", ctypes.c_int32 * 2),
        ("grid_dim", ctypes.c_int32 * 2),
        ("clip_dim", ctypes.c_int32 * 2),
        ("object_dim", ctypes.c_int32 * 2),
        ("object_pos", ctypes.c_int32 * 2),
        ("answer_dim", ctypes.c_int32 * 2),
        ("active", ctypes.c_int32),
        ("rotation_parity", ctypes.c_int32),
        ("trials_remain", ctypes.c_int8),
        ("terminated", ctypes.c_int32),
        ("reset_on_submit", ctypes.c_int32),
        ("max_trial", ctypes.c_int32),
        ("submit_count", ctypes.c_int32),
        ("steps", ctypes.c_int32),
        ("last_action_op", ctypes.c_int32),
        ("last_reward", ctypes.c_float),
        ("H", ctypes.c_int32),
        ("W", ctypes.c_int32),
    ]


def _load_engine() -> Optional[ctypes.CDLL]:
    global _elib, _ebuild_failed
    with _lock:
        if _elib is not None or _ebuild_failed:
            return _elib
        try:
            if (not os.path.exists(_ESO)
                    or os.path.getmtime(_ESO) < os.path.getmtime(_ESRC)):
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-o", _ESO, _ESRC],
                    check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(_ESO)
            lib.engine_state_size.restype = ctypes.c_int
            i8p = ctypes.POINTER(ctypes.c_int8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.engine_reset.restype = None
            lib.engine_reset.argtypes = [
                ctypes.POINTER(_CState), i8p, ctypes.c_int, ctypes.c_int,
                i8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
            lib.engine_step.restype = ctypes.c_int
            lib.engine_step.argtypes = [
                ctypes.POINTER(_CState), i8p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
            lib.engine_run.restype = ctypes.c_int
            lib.engine_run.argtypes = [
                ctypes.POINTER(_CState), i8p, i32p, i32p, i32p, i32p,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float), i8p]
            assert lib.engine_state_size() == ctypes.sizeof(_CState), (
                lib.engine_state_size(), ctypes.sizeof(_CState))
            _elib = lib
        except Exception:
            _ebuild_failed = True
        return _elib


def engine_available() -> bool:
    return _load_engine() is not None


class NativeEngine:
    """C++ single-env engine behind the oracle's step surface.

    Table-driven like the JAX engine: any :class:`~arcle_tpu.ops.table
    .OpTable` family runs through the one compiled transition.  Used by
    the gym adapters at B=1 (``backend="native"``), where it replaces
    both the per-step device dispatch and the reference's NumPy loop.
    """

    def __init__(self, table, H: int = 30, W: int = 30,
                 max_trial: int = -1):
        lib = _load_engine()
        if lib is None:
            raise RuntimeError("native engine unavailable (g++ build failed)")
        self._lib = lib
        self.table = table
        self.H, self.W = H, W
        self.max_trial = max_trial
        self._st = _CState()
        n = table.n_ops
        self._grp = np.asarray(table.group, np.int32)
        self._par = np.asarray(table.param, np.int32)
        self._rs = np.asarray(table.reset_sel, np.int32)
        self._is_sub = (np.arange(n) == table.submit_op).astype(np.int32)
        # per-op python-int rows + reusable ctypes out-params: the
        # per-step FFI path must not touch numpy scalar conversion
        self._rows = [(int(self._grp[i]), int(self._par[i]),
                       int(self._rs[i]), int(self._is_sub[i]))
                      for i in range(n)]
        self._rew = ctypes.c_float(0.0)
        self._rew_ref = ctypes.byref(self._rew)
        self._st_ref = ctypes.byref(self._st)
        self._i8p = ctypes.POINTER(ctypes.c_int8)
        # zero-copy numpy views over the state buffer, built once — the
        # adapters return these as observations (the reference likewise
        # exposes its live mutable state dict, base.py:24)
        P = H * W
        gv = lambda name: np.ctypeslib.as_array(
            getattr(self._st, name))[:P].reshape(H, W)
        self._v = {k: gv(k) for k in
                   ("input", "grid", "selected", "clip", "object",
                    "object_sel", "background")}
        for k in ("input_dim", "grid_dim", "clip_dim", "object_dim",
                  "object_pos"):
            self._v[k] = np.ctypeslib.as_array(getattr(self._st, k))

    @property
    def n_ops(self) -> int:
        return self.table.n_ops

    def reset(self, input_grid: np.ndarray, answer: np.ndarray,
              reset_on_submit: bool = False) -> None:
        inp = np.ascontiguousarray(input_grid, np.int8)
        ans = np.ascontiguousarray(answer, np.int8)
        self._lib.engine_reset(
            ctypes.byref(self._st),
            inp.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            inp.shape[0], inp.shape[1],
            ans.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ans.shape[0], ans.shape[1],
            self.max_trial, int(reset_on_submit), self.H, self.W)

    def step(self, selection: np.ndarray, operation: int):
        """One transition; returns (reward, terminated)."""
        sel = np.ascontiguousarray(selection, np.int8)
        op = int(operation)
        g, p, rsf, sub = self._rows[op]
        term = self._lib.engine_step(
            self._st_ref, ctypes.cast(sel.ctypes.data, self._i8p),
            g, p, rsf, sub, self._rew_ref)
        self._st.last_action_op = op
        return float(self._rew.value), bool(term)

    def run(self, selections: np.ndarray, operations: np.ndarray):
        """Step a whole action sequence in one FFI call; returns
        (rewards f32 [n], terminated bool [n])."""
        n = len(operations)
        sels = np.ascontiguousarray(
            selections.reshape(n, self.H * self.W), np.int8)
        ops = np.asarray(operations, np.int32)
        grp = np.ascontiguousarray(self._grp[ops])
        par = np.ascontiguousarray(self._par[ops])
        rs = np.ascontiguousarray(self._rs[ops])
        sub = np.ascontiguousarray(self._is_sub[ops])
        rew = np.zeros(n, np.float32)
        term = np.zeros(n, np.int8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._lib.engine_run(
            ctypes.byref(self._st),
            sels.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            grp.ctypes.data_as(i32p), par.ctypes.data_as(i32p),
            rs.ctypes.data_as(i32p), sub.ctypes.data_as(i32p),
            n, rew.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            term.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        if n:
            self._st.last_action_op = int(ops[-1])
        return rew, term.astype(bool)

    # -- observation views (oracle state-dict format) --
    def _grid(self, name: str) -> np.ndarray:
        return self._v[name]

    def _dim(self, name: str) -> np.ndarray:
        return self._v[name].astype(np.int8)

    def observation(self, keys=()) -> dict:
        """Zero-copy observation dict in the reference layout.  The grid
        arrays are *views* over the engine state, and the small scalar/dim
        arrays are cached buffers updated in place (mutated by the next
        step) — the same aliasing the reference's ``current_state``
        exposes.  ``keys``: include "clip" / "selected" groups."""
        s, v = self._st, self._v
        if not hasattr(self, "_obs_cache"):
            i8 = lambda n: np.zeros(n, np.int8)
            obs = {"trials_remain": i8(1), "terminated": i8(1),
                   "input": v["input"], "input_dim": i8(2),
                   "grid": v["grid"], "grid_dim": i8(2)}
            if "clip" in keys:
                obs["clip"] = v["clip"]
                obs["clip_dim"] = i8(2)
            if "selected" in keys:
                obs["selected"] = v["selected"]
                obs["object_states"] = {
                    "active": i8(1), "object": v["object"],
                    "object_sel": v["object_sel"], "object_dim": i8(2),
                    "object_pos": i8(2), "background": v["background"],
                    "rotation_parity": i8(1)}
            self._obs_cache = obs
        obs = self._obs_cache
        obs["trials_remain"][0] = s.trials_remain
        obs["terminated"][0] = s.terminated
        obs["input_dim"][:] = v["input_dim"]
        obs["grid_dim"][:] = v["grid_dim"]
        if "clip" in keys:
            obs["clip_dim"][:] = v["clip_dim"]
        if "selected" in keys:
            od = obs["object_states"]
            od["active"][0] = s.active
            od["object_dim"][:] = v["object_dim"]
            od["object_pos"][:] = v["object_pos"]
            od["rotation_parity"][0] = s.rotation_parity
        return obs

    def state_dict(self) -> dict:
        """Snapshot in the oracle/reference ``current_state`` layout."""
        s = self._st
        return {
            "trials_remain": np.array([s.trials_remain], np.int8),
            "terminated": np.array([s.terminated], np.int8),
            "input": self._grid("input").copy(),
            "input_dim": self._dim("input_dim"),
            "grid": self._grid("grid").copy(),
            "grid_dim": self._dim("grid_dim"),
            "selected": self._grid("selected").copy(),
            "clip": self._grid("clip").copy(),
            "clip_dim": self._dim("clip_dim"),
            "object_states": {
                "active": np.array([s.active], np.int8),
                "object": self._grid("object").copy(),
                "object_sel": self._grid("object_sel").copy(),
                "object_dim": self._dim("object_dim"),
                "object_pos": self._dim("object_pos"),
                "background": self._grid("background").copy(),
                "rotation_parity": np.array([s.rotation_parity], np.int8),
            },
            "_submit_count": s.submit_count,
            "_steps": s.steps,
        }


__all__ = ["available", "bake_task_native", "engine_available",
           "NativeEngine"]
