"""NumPy oracle of the reference environment semantics.

This is the ground-truth model for the parity suite: a compact, sequential
re-statement of the reference's operator semantics
(/root/reference/arcle/actions/{color,object,critical}.py and
envs/{base,arcenv,o2arcenv}.py), used to

1. cross-validate against the *actual* reference package (executed from
   /root/reference in ``tests/test_oracle_vs_reference.py``), and
2. serve as the bit-exact target the JAX engine is fuzzed against.

It deliberately reproduces the reference's quirks: Color writing outside
grid_dim, FloodFill's single-pixel rule, Copy's strictly-greater bound
check, Paste clipping to the frame rather than grid_dim, the discarded
state dict on reset_on_submit, and negative trial counters.

Flood fill here is an iterative stack walk (no recursion-limit hazard);
the result set is identical to the reference's recursive DFS.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


# EnvState field -> the oracle state entry it equals after every step
STATE_FIELDS = (
    ("trials_remain", lambda o: o["trials_remain"][0]),
    ("terminated", lambda o: o["terminated"][0]),
    ("input", lambda o: o["input"]),
    ("input_dim", lambda o: o["input_dim"]),
    ("grid", lambda o: o["grid"]),
    ("grid_dim", lambda o: o["grid_dim"]),
    ("selected", lambda o: o["selected"]),
    ("clip", lambda o: o["clip"]),
    ("clip_dim", lambda o: o["clip_dim"]),
    ("active", lambda o: o["object_states"]["active"][0]),
    ("object", lambda o: o["object_states"]["object"]),
    ("object_sel", lambda o: o["object_states"]["object_sel"]),
    ("object_dim", lambda o: o["object_states"]["object_dim"]),
    ("object_pos", lambda o: o["object_states"]["object_pos"]),
    ("background", lambda o: o["object_states"]["background"]),
    ("rotation_parity", lambda o: o["object_states"]["rotation_parity"][0]),
)
_CORE = ("trials_remain", "terminated", "input", "input_dim", "grid",
         "grid_dim")
# the fields each family's observation carries (raw: the core grid state;
# ARC-27 adds the clipboard; O2ARCv2 adds selection and the object machine)
FAMILY_FIELDS = {
    "raw": tuple(f for f in STATE_FIELDS if f[0] in _CORE),
    "arc": tuple(f for f in STATE_FIELDS
                 if f[0] in _CORE + ("clip", "clip_dim")),
    "o2arc": STATE_FIELDS,
}


def new_state(input_grid: np.ndarray, answer: np.ndarray,
              H: int = 30, W: int = 30, max_trial: int = -1,
              reset_on_submit: bool = False) -> Dict:
    """Fresh state dict for a task pair (base.py:155-166 + o2arcenv.py:16-34).

    ``input_grid`` / ``answer`` are the *unpadded* task grids.
    """
    ih, iw = input_grid.shape
    grid = np.zeros((H, W), np.int8)
    grid[:ih, :iw] = input_grid
    st = {
        "trials_remain": np.array([max_trial], np.int8),
        "terminated": np.array([0], np.int8),
        "input": grid.copy(),
        "input_dim": np.array([ih, iw], np.int8),
        "grid": grid.copy(),
        "grid_dim": np.array([ih, iw], np.int8),
        "selected": np.zeros((H, W), np.int8),
        "clip": np.zeros((H, W), np.int8),
        "clip_dim": np.zeros((2,), np.int8),
        "object_states": {
            "active": np.zeros((1,), np.int8),
            "object": np.zeros((H, W), np.int8),
            "object_sel": np.zeros((H, W), np.int8),
            "object_dim": np.zeros((2,), np.int8),
            "object_pos": np.zeros((2,), np.int8),
            "background": np.zeros((H, W), np.int8),
            "rotation_parity": np.zeros((1,), np.int8),
        },
    }
    # oracle-side task context / bookkeeping (env attributes in the reference)
    st["_answer"] = np.asarray(answer, np.int8)
    st["_max_trial"] = max_trial
    st["_reset_on_submit"] = reset_on_submit
    st["_input_raw"] = np.asarray(input_grid, np.int8)
    st["_submit_count"] = 0
    st["_steps"] = 0
    return st


def _bbox(mask: np.ndarray) -> Tuple[int, int, int, int]:
    rr = np.flatnonzero(mask.any(axis=1))
    cc = np.flatnonzero(mask.any(axis=0))
    return int(rr[0]), int(rr[-1]), int(cc[0]), int(cc[-1])


def _flood_component(grid: np.ndarray, dims, seed) -> np.ndarray:
    """4-connected same-color region of seed within dims, iteratively."""
    h, w = int(dims[0]), int(dims[1])
    color = grid[seed]
    out = np.zeros_like(grid)
    stack = [seed]
    out[seed] = 1
    while stack:
        x, y = stack.pop()
        for nx, ny in ((x - 1, y), (x + 1, y), (x, y - 1), (x, y + 1)):
            if 0 <= nx < h and 0 <= ny < w and not out[nx, ny] \
                    and grid[nx, ny] == color:
                out[nx, ny] = 1
                stack.append((nx, ny))
    return out


class OracleOps:
    """The 35-op semantic surface as in-place state mutations."""

    # -- selection bookkeeping (object.py:10-26) --
    @staticmethod
    def reset_sel(st: Dict) -> None:
        st["selected"] = np.zeros_like(st["selected"])
        st["object_states"]["active"][0] = 0

    # -- color ops --
    @staticmethod
    def color(st: Dict, sel: np.ndarray, c: int) -> None:
        if not sel.any():
            return
        g = st["grid"].copy()
        g[sel != 0] = c
        st["grid"] = g

    @staticmethod
    def flood(st: Dict, sel: np.ndarray, c: int) -> None:
        if int(sel.astype(np.int64).sum()) != 1:
            return
        x, y = np.unravel_index(int(np.argmax(sel)), sel.shape)
        if x >= st["grid_dim"][0] or y >= st["grid_dim"][1]:
            return
        comp = _flood_component(st["grid"], st["grid_dim"], (int(x), int(y)))
        g = st["grid"].copy()
        g[comp != 0] = c
        st["grid"] = g

    # -- object-selection machine (object.py:60-165) --
    @staticmethod
    def _objsel_begin(st: Dict, sel: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
        od = st["object_states"]
        if sel.any():
            rmin, rmax, cmin, cmax = _bbox(sel)
            h, w = rmax - rmin + 1, cmax - cmin + 1
            part = sel[rmin:rmax + 1, cmin:cmax + 1] > 0
            od["object_dim"][:] = (h, w)
            od["object"][:, :] = 0
            od["object"][0:h, 0:w][part] = st["grid"][rmin:rmax + 1, cmin:cmax + 1][part]
            od["object_sel"][:, :] = 0
            od["object_sel"][0:h, 0:w][part] = 1
            od["background"][:, :] = st["grid"]
            od["background"][sel > 0] = 0
            od["object_pos"][:] = (rmin, cmin)
            od["active"][0] = 1
            od["rotation_parity"][0] = 0
            st["selected"][:, :] = sel.astype(np.int8)
            return rmin, rmax, cmin, cmax
        if od["active"][0]:
            x, y = (int(v) for v in od["object_pos"])
            h, w = (int(v) for v in od["object_dim"])
            return x, x + h - 1, y, y + w - 1
        return None

    @staticmethod
    def _compose(st: Dict) -> None:
        """_apply_patch + _apply_sel (object.py:113-165)."""
        od = st["object_states"]
        x, y = (int(v) for v in od["object_pos"])
        h, w = (int(v) for v in od["object_dim"])
        gh, gw = (int(v) for v in st["grid_dim"])

        st["grid"][:, :] = od["background"]
        st["selected"][:, :] = 0
        if x + h > 0 and x < gh and y + w > 0 and y < gw:
            sx, ex = max(0, x), min(gh, x + h)
            sy, ey = max(0, y), min(gw, y + w)
            patch = od["object"][sx - x:ex - x, sy - y:ey - y]
            target = st["grid"][sx:ex, sy:ey]
            target[patch > 0] = patch[patch > 0]
            st["selected"][sx:ex, sy:ey] = \
                od["object_sel"][sx - x:ex - x, sy - y:ey - y]

    @staticmethod
    def _repack(dst: np.ndarray, block: np.ndarray) -> None:
        """_pad_assign (object.py:43-47)."""
        h, w = block.shape
        dst[:h, :w] = block
        dst[h:, :] = 0
        dst[:, w:] = 0

    @staticmethod
    def move(st: Dict, sel: np.ndarray, d: int) -> None:
        if OracleOps._objsel_begin(st, sel) is None:
            return
        od = st["object_states"]
        dx, dy = ((-1, 0), (1, 0), (0, 1), (0, -1))[d]
        x, y = (int(v) for v in od["object_pos"])
        od["object_pos"][:] = (x + dx, y + dy)
        OracleOps._compose(st)

    @staticmethod
    def rotate(st: Dict, sel: np.ndarray, k: int) -> None:
        box = OracleOps._objsel_begin(st, sel)
        if box is None:
            return
        rmin, rmax, cmin, cmax = box
        od = st["object_states"]
        h, w = (int(v) for v in od["object_dim"])
        cx = (rmin + rmax) * 0.5
        cy = (cmin + cmax) * 0.5
        if h % 2 == w % 2:
            x, y = (int(v) for v in od["object_pos"])
            od["object_pos"][:] = (int(np.floor(cx - cy + y)),
                                   int(np.floor(cy - cx + x)))
            od["object_dim"][:] = (w, h)
        else:
            od["rotation_parity"][0] = (od["rotation_parity"][0] + k) % 2
            sig = (k + 2) % 4 - 2
            mod = 1 - int(od["rotation_parity"][0])
            mx = min(cx + sig * (cy - cmin), cx + sig * (cy - cmax)) + mod
            my = min(cy - sig * (cx - rmin), cy - sig * (cx - rmax)) + mod
            od["object_pos"][:] = (int(np.floor(mx)), int(np.floor(my)))
            od["object_dim"][:] = (w, h)
        OracleOps._repack(od["object"], np.rot90(od["object"][:h, :w], k=k))
        OracleOps._repack(od["object_sel"], np.rot90(od["object_sel"][:h, :w], k=k))
        OracleOps._compose(st)

    @staticmethod
    def flip(st: Dict, sel: np.ndarray, axis: str) -> None:
        if OracleOps._objsel_begin(st, sel) is None:
            return
        od = st["object_states"]
        h, w = (int(v) for v in od["object_dim"])
        fns = {"H": np.fliplr, "V": np.flipud,
               "D0": lambda a: np.rot90(np.fliplr(a)),
               "D1": lambda a: np.fliplr(np.rot90(a))}
        f = fns[axis]
        OracleOps._repack(od["object"], f(od["object"][:h, :w]))
        OracleOps._repack(od["object_sel"], f(od["object_sel"][:h, :w]))
        OracleOps._compose(st)

    # -- clipboard (object.py:281-349) --
    @staticmethod
    def copy(st: Dict, sel: np.ndarray, src_input: bool) -> None:
        if not (sel > 0).any():
            return
        rmin, rmax, cmin, cmax = _bbox(sel)
        key = "input" if src_input else "grid"
        sh, sw = (int(v) for v in st[key + "_dim"])
        if rmax > sh or cmax > sw:   # strictly greater: reference parity
            return
        h, w = rmax - rmin + 1, cmax - cmin + 1
        st["clip"][:, :] = 0
        st["clip_dim"][:] = (h, w)
        block = st[key][rmin:rmax + 1, cmin:cmax + 1]
        cond = (block != 0) & (sel[rmin:rmax + 1, cmin:cmax + 1] != 0)
        st["clip"][:h, :w][cond] = block[cond]

    @staticmethod
    def paste(st: Dict, sel: np.ndarray, blank: bool = True) -> None:
        if not (sel > 0).any():
            return
        rmin, _, cmin, _ = _bbox(sel)
        H, W = st["input"].shape
        h, w = (int(v) for v in st["clip_dim"])
        if rmin >= H or cmin >= W or h == 0 or w == 0:
            return
        ex, ey = min(rmin + h, H), min(cmin + w, W)
        patch = st["clip"][:ex - rmin, :ey - cmin]
        if blank:
            st["grid"][rmin:ex, cmin:ey] = patch
        else:
            tgt = st["grid"][rmin:ex, cmin:ey]
            tgt[patch > 0] = patch[patch > 0]

    # -- critical (critical.py) --
    @staticmethod
    def copy_from_input(st: Dict, sel: np.ndarray) -> None:
        st["grid_dim"] = st["input_dim"].copy()
        st["grid"][:, :] = st["input"]

    @staticmethod
    def reset_grid(st: Dict, sel: np.ndarray) -> None:
        st["grid"][:, :] = 0

    @staticmethod
    def resize_grid(st: Dict, sel: np.ndarray) -> None:
        if not sel.any():
            return
        rmin, rmax, cmin, cmax = _bbox(sel)
        st["grid"][:, :] = 0
        st["grid_dim"][:] = (rmax - rmin + 1, cmax - cmin + 1)

    @staticmethod
    def crop_grid(st: Dict, sel: np.ndarray) -> None:
        if not sel.any():
            return
        rmin, rmax, cmin, cmax = _bbox(sel)
        h, w = rmax - rmin + 1, cmax - cmin + 1
        block = st["grid"][rmin:rmax + 1, cmin:cmax + 1]
        cond = (sel[rmin:rmax + 1, cmin:cmax + 1] != 0) & (block != 0)
        patch = np.zeros((h, w), np.int8)
        patch[cond] = block[cond]
        st["grid"][:, :] = 0
        st["grid"][:h, :w] = patch
        st["grid_dim"][:] = (h, w)

    @staticmethod
    def resize_to_answer(st: Dict, sel: np.ndarray) -> None:
        h, w = st["_answer"].shape
        st["grid_dim"] = np.array([h, w], np.int8)
        st["grid"][h:, :] = 0
        st["grid"][:, w:] = 0

    # -- submit (base.py:172-183) --
    @staticmethod
    def submit(st: Dict, sel: np.ndarray) -> Optional[Dict]:
        """Returns a replacement state dict when reset_on_submit re-inits."""
        replacement = None
        if st["trials_remain"][0] != 0:
            st["trials_remain"][0] -= 1
            st["_submit_count"] += 1
            h, w = (int(v) for v in st["grid_dim"])
            ans = st["_answer"]
            if ans.shape == (h, w) and (ans == st["grid"][:h, :w]).all():
                st["terminated"][0] = 1
            if st["_reset_on_submit"]:
                replacement = new_state(
                    st["_input_raw"], ans, *st["input"].shape,
                    max_trial=st["_max_trial"], reset_on_submit=True)
                replacement["_submit_count"] = st["_submit_count"]
                replacement["_steps"] = st["_steps"]
        if st["trials_remain"][0] == 0:
            st["terminated"][0] = 1   # lands on the discarded dict under ros
        return replacement


class OracleEnv:
    """Sequential oracle env over any of the three family op tables.

    ``family`` in {"raw", "arc", "o2arc", "o2arc_crop33", "o2arc_nofill"}.
    """

    def __init__(self, family: str = "o2arc", H: int = 30, W: int = 30,
                 max_trial: int = -1):
        self.family = family
        self.H, self.W = H, W
        self.max_trial = max_trial
        self.state: Dict = {}
        self._dispatch = self._build_dispatch(family)

    # op index -> (callable(st, sel), wrap_reset_sel)
    def _build_dispatch(self, family: str):
        O = OracleOps
        if family == "raw":
            ops = [(lambda st, sel, c=c: O.color(st, sel, c), False)
                   for c in range(10)]
            ops.append((O.resize_to_answer, False))
            ops.append(("submit", False))
            return ops
        if family == "arc":
            ops = [(lambda st, sel, c=c: O.color(st, sel, c), False)
                   for c in range(10)]
            ops += [(lambda st, sel, c=c: O.flood(st, sel, c), False)
                    for c in range(10)]
            ops += [(lambda st, sel: O.copy(st, sel, True), False),
                    (lambda st, sel: O.copy(st, sel, False), False),
                    (lambda st, sel: O.paste(st, sel, True), False),
                    (O.copy_from_input, False), (O.reset_grid, False),
                    (O.resize_grid, False), ("submit", False)]
            return ops
        # O2ARC variants
        ops = [(lambda st, sel, c=c: O.color(st, sel, c), True)
               for c in range(10)]
        fills = [(lambda st, sel, c=c: O.flood(st, sel, c), True)
                 for c in range(10)]
        if family != "o2arc_nofill":
            ops += fills
        ops += [(lambda st, sel, d=d: O.move(st, sel, d), False)
                for d in range(4)]
        ops += [(lambda st, sel: O.rotate(st, sel, 1), False),
                (lambda st, sel: O.rotate(st, sel, 3), False),
                (lambda st, sel: O.flip(st, sel, "H"), False),
                (lambda st, sel: O.flip(st, sel, "V"), False),
                (lambda st, sel: O.copy(st, sel, True), True),
                (lambda st, sel: O.copy(st, sel, False), True),
                (lambda st, sel: O.paste(st, sel, True), True),
                (O.copy_from_input, True), (O.reset_grid, True)]
        if family == "o2arc_crop33":
            ops.append((O.crop_grid, True))
        else:
            ops.append((O.resize_grid, True))
        ops.append(("submit", False))
        return ops

    @property
    def n_ops(self) -> int:
        return len(self._dispatch)

    def reset(self, input_grid: np.ndarray, answer: np.ndarray,
              reset_on_submit: bool = False) -> Dict:
        self.state = new_state(input_grid, answer, self.H, self.W,
                               self.max_trial, reset_on_submit)
        return self.state

    def step(self, selection: np.ndarray, operation: int):
        st = self.state
        fn, wrap = self._dispatch[operation]
        sel = np.asarray(selection, np.int8)
        if wrap:
            OracleOps.reset_sel(st)
        if fn == "submit":
            repl = OracleOps.submit(st, sel)
            if repl is not None:
                self.state = st = repl
        else:
            fn(st, sel)
        # sparse reward (o2arcenv.py:121-128 / arcenv.py:51-58)
        reward = 0.0
        if operation == self.n_ops - 1:
            h, w = (int(v) for v in st["grid_dim"])
            ans = st["_answer"]
            if ans.shape == (h, w) and (ans == st["grid"][:h, :w]).all():
                reward = 1.0
        st["_steps"] += 1
        return st, reward, bool(st["terminated"][0])
