// Native single-env engine: the full table-driven ARCLE transition in C++.
//
// The batched compute path is JAX/XLA; this engine serves the
// *interactive* B=1 surface (the gym adapters), where per-step device
// dispatch dominates and a host-native step beats both a device
// round-trip and the reference's NumPy implementation.  Semantics are a transcription of the validated NumPy
// oracle (arcle_tpu/oracle/oracle_env.py), which is itself fuzzed against
// the executed reference package (tests/test_oracle_vs_reference.py);
// this engine is fuzzed against the oracle in tests/test_native.py.
//
// Reference quirks deliberately preserved (see oracle_env.py docstring):
// Color writes outside grid_dim; FloodFill requires exactly one selected
// pixel inside grid_dim; Copy bound check is strictly-greater; Paste
// clips to the 30x30 frame, not grid_dim; reset_on_submit discards the
// post-check state; trials_remain decrements in int8 (negative = endless).
//
// The op table rides in per call as (group, param, reset_sel) — the same
// static rows as ops/table.py OpTable — so one binary serves every env
// family (Raw/ARC-27/O2ARC/NoFill/crop33) with zero family enums here.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int MAXHW = 30;
constexpr int MAXP = MAXHW * MAXHW;

// group enum: mirror of ops/groups.py G
enum Group {
    G_NOOP = 0, G_COLOR = 1, G_FLOOD = 2, G_OBJECT = 3, G_COPY = 4,
    G_PASTE = 5, G_COPY_FROM_INPUT = 6, G_RESET_GRID = 7,
    G_RESIZE_GRID = 8, G_CROP_GRID = 9, G_SUBMIT = 10,
    G_RESIZE_TO_ANSWER = 11,
};

// object sub-kind enum: mirror of ops/groups.py OBJ
enum ObjKind {
    O_MOVE_U = 0, O_MOVE_D = 1, O_MOVE_R = 2, O_MOVE_L = 3,
    O_ROT_90 = 4, O_ROT_270 = 5, O_FLIP_H = 6, O_FLIP_V = 7,
    O_FLIP_D0 = 8, O_FLIP_D1 = 9,
};

}  // namespace

extern "C" {

// Fixed-layout state; the Python side wraps the buffers as numpy views.
// Grids are row-major [H, W] int8 within a MAXHW*MAXHW frame slice
// [0:H, 0:W]; H/W <= 30 set at reset.
struct NativeState {
    int8_t input[MAXP];
    int8_t grid[MAXP];
    int8_t selected[MAXP];
    int8_t clip[MAXP];
    int8_t object[MAXP];
    int8_t object_sel[MAXP];
    int8_t background[MAXP];
    int8_t answer[MAXP];
    int32_t input_dim[2];
    int32_t grid_dim[2];
    int32_t clip_dim[2];
    int32_t object_dim[2];
    int32_t object_pos[2];   // the only signed-position field
    int32_t answer_dim[2];
    int32_t active;
    int32_t rotation_parity;
    int8_t trials_remain;    // int8 semantics (negative = endless)
    int32_t terminated;
    int32_t reset_on_submit;
    int32_t max_trial;
    int32_t submit_count;
    int32_t steps;
    int32_t last_action_op;
    float last_reward;
    int32_t H;
    int32_t W;
};

}  // extern "C"

namespace {

inline int idx(const NativeState* s, int r, int c) { return r * s->W + c; }

// the reference keeps object_pos in int8 (the only signed field,
// o2arcenv.py:53-62) — emulate its wraparound for bit-exactness
inline int32_t wrap8(long v) { return static_cast<int8_t>(v); }

void zero_grid(NativeState* s, int8_t* g) {
    std::memset(g, 0, static_cast<size_t>(s->H) * s->W);
}

bool bbox(const NativeState* s, const int8_t* mask,
          int* rmin, int* rmax, int* cmin, int* cmax) {
    int r0 = -1, r1 = -1, c0 = s->W, c1 = -1;
    for (int r = 0; r < s->H; ++r) {
        int rowlo = -1, rowhi = -1;
        const int8_t* row = mask + r * s->W;
        for (int c = 0; c < s->W; ++c) {
            if (row[c]) { if (rowlo < 0) rowlo = c; rowhi = c; }
        }
        if (rowlo >= 0) {
            if (r0 < 0) r0 = r;
            r1 = r;
            if (rowlo < c0) c0 = rowlo;
            if (rowhi > c1) c1 = rowhi;
        }
    }
    if (r0 < 0) return false;
    *rmin = r0; *rmax = r1; *cmin = c0; *cmax = c1;
    return true;
}

// -- object-selection machine (oracle _objsel_begin) --
bool objsel_begin(NativeState* s, const int8_t* sel,
                  int* rmin, int* rmax, int* cmin, int* cmax) {
    int r0, r1, c0, c1;
    if (bbox(s, sel, &r0, &r1, &c0, &c1)) {
        int h = r1 - r0 + 1, w = c1 - c0 + 1;
        s->object_dim[0] = h; s->object_dim[1] = w;
        zero_grid(s, s->object);
        zero_grid(s, s->object_sel);
        for (int r = 0; r < h; ++r)
            for (int c = 0; c < w; ++c) {
                if (sel[idx(s, r0 + r, c0 + c)] > 0) {
                    s->object[idx(s, r, c)] = s->grid[idx(s, r0 + r, c0 + c)];
                    s->object_sel[idx(s, r, c)] = 1;
                }
            }
        std::memcpy(s->background, s->grid,
                    static_cast<size_t>(s->H) * s->W);
        for (int i = 0; i < s->H * s->W; ++i)
            if (sel[i] > 0) s->background[i] = 0;
        s->object_pos[0] = r0; s->object_pos[1] = c0;
        s->active = 1;
        s->rotation_parity = 0;
        std::memcpy(s->selected, sel, static_cast<size_t>(s->H) * s->W);
        *rmin = r0; *rmax = r1; *cmin = c0; *cmax = c1;
        return true;
    }
    if (s->active) {
        int x = s->object_pos[0], y = s->object_pos[1];
        int h = s->object_dim[0], w = s->object_dim[1];
        *rmin = x; *rmax = x + h - 1; *cmin = y; *cmax = y + w - 1;
        return true;
    }
    return false;
}

// -- _apply_patch + _apply_sel (oracle _compose) --
void compose(NativeState* s) {
    int x = s->object_pos[0], y = s->object_pos[1];
    int h = s->object_dim[0], w = s->object_dim[1];
    int gh = s->grid_dim[0], gw = s->grid_dim[1];
    std::memcpy(s->grid, s->background, static_cast<size_t>(s->H) * s->W);
    zero_grid(s, s->selected);
    if (x + h > 0 && x < gh && y + w > 0 && y < gw) {
        int sx = x > 0 ? x : 0, ex = (x + h < gh) ? x + h : gh;
        int sy = y > 0 ? y : 0, ey = (y + w < gw) ? y + w : gw;
        for (int r = sx; r < ex; ++r)
            for (int c = sy; c < ey; ++c) {
                int8_t p = s->object[idx(s, r - x, c - y)];
                if (p > 0) s->grid[idx(s, r, c)] = p;
                s->selected[idx(s, r, c)] =
                    s->object_sel[idx(s, r - x, c - y)];
            }
    }
}

// rewrite the object/object_sel buffers with a transformed (h,w) block,
// zeroing the rest (_pad_assign).  ``h``/``w`` are the PRE-transform
// dims (the oracle captures them before updating object_dim).
void repack_transform(NativeState* s, int kind, int h, int w) {
    int8_t tmp_o[MAXP], tmp_s[MAXP];
    int nh = h, nw = w;
    // destination index for source (r, c)
    for (int r = 0; r < h; ++r)
        for (int c = 0; c < w; ++c) {
            int dr = 0, dc = 0;
            switch (kind) {
                case O_ROT_90:  nh = w; nw = h; dr = w - 1 - c; dc = r; break;
                case O_ROT_270: nh = w; nw = h; dr = c; dc = h - 1 - r; break;
                case O_FLIP_H:  dr = r; dc = w - 1 - c; break;
                case O_FLIP_V:  dr = h - 1 - r; dc = c; break;
                case O_FLIP_D0: nh = w; nw = h; dr = c; dc = r; break;
                case O_FLIP_D1: nh = w; nw = h;
                                dr = w - 1 - c; dc = h - 1 - r; break;
                default: dr = r; dc = c; break;
            }
            tmp_o[dr * nw + dc] = s->object[idx(s, r, c)];
            tmp_s[dr * nw + dc] = s->object_sel[idx(s, r, c)];
        }
    zero_grid(s, s->object);
    zero_grid(s, s->object_sel);
    for (int r = 0; r < nh; ++r)
        for (int c = 0; c < nw; ++c) {
            s->object[idx(s, r, c)] = tmp_o[r * nw + c];
            s->object_sel[idx(s, r, c)] = tmp_s[r * nw + c];
        }
}

void op_color(NativeState* s, const int8_t* sel, int color) {
    bool any = false;
    for (int i = 0; i < s->H * s->W; ++i) if (sel[i]) { any = true; break; }
    if (!any) return;
    for (int i = 0; i < s->H * s->W; ++i)
        if (sel[i]) s->grid[i] = static_cast<int8_t>(color);
}

void op_flood(NativeState* s, const int8_t* sel, int color) {
    // oracle semantics: sum of selection VALUES must be exactly 1, and
    // the seed is argmax (first occurrence of the max value)
    long total = 0;
    int seed = 0;
    int8_t best = sel[0];
    for (int i = 0; i < s->H * s->W; ++i) {
        total += sel[i];
        if (sel[i] > best) { best = sel[i]; seed = i; }
    }
    if (total != 1) return;
    int x = seed / s->W, y = seed % s->W;
    int gh = s->grid_dim[0], gw = s->grid_dim[1];
    if (x >= gh || y >= gw) return;
    int8_t target = s->grid[seed];
    // iterative BFS over the 4-connected same-color region within dims
    int stack[MAXP];
    int8_t seen[MAXP];
    std::memset(seen, 0, sizeof(seen));
    int top = 0;
    stack[top++] = seed;
    seen[seed] = 1;
    while (top) {
        int cur = stack[--top];
        int cx = cur / s->W, cy = cur % s->W;
        const int nx[4] = {cx - 1, cx + 1, cx, cx};
        const int ny[4] = {cy, cy, cy - 1, cy + 1};
        for (int k = 0; k < 4; ++k) {
            if (nx[k] < 0 || nx[k] >= gh || ny[k] < 0 || ny[k] >= gw)
                continue;
            int ni = nx[k] * s->W + ny[k];
            if (!seen[ni] && s->grid[ni] == target) {
                seen[ni] = 1;
                stack[top++] = ni;
            }
        }
    }
    for (int i = 0; i < s->H * s->W; ++i)
        if (seen[i]) s->grid[i] = static_cast<int8_t>(color);
}

void op_object(NativeState* s, const int8_t* sel, int kind) {
    int r0, r1, c0, c1;
    if (!objsel_begin(s, sel, &r0, &r1, &c0, &c1)) return;
    int h = s->object_dim[0], w = s->object_dim[1];
    if (kind <= O_MOVE_L) {
        static const int dx[4] = {-1, 1, 0, 0};
        static const int dy[4] = {0, 0, 1, -1};
        s->object_pos[0] = wrap8(static_cast<long>(s->object_pos[0]) + dx[kind]);
        s->object_pos[1] = wrap8(static_cast<long>(s->object_pos[1]) + dy[kind]);
    } else if (kind == O_ROT_90 || kind == O_ROT_270) {
        int k = (kind == O_ROT_90) ? 1 : 3;
        double cx = (r0 + r1) * 0.5, cy = (c0 + c1) * 0.5;
        if ((h % 2) == (w % 2)) {
            int x = s->object_pos[0], y = s->object_pos[1];
            // even/even or odd/odd: recenter corner diagonally
            s->object_pos[0] = wrap8(static_cast<long>(std::floor(cx - cy + y)));
            s->object_pos[1] = wrap8(static_cast<long>(std::floor(cy - cx + x)));
        } else {
            // ill-posed rotation: parity-tracked floor (object.py:197-207)
            s->rotation_parity = (s->rotation_parity + k) % 2;
            int sig = (k + 2) % 4 - 2;
            int mod = 1 - s->rotation_parity;
            double a1 = cx + sig * (cy - c0), a2 = cx + sig * (cy - c1);
            double b1 = cy - sig * (cx - r0), b2 = cy - sig * (cx - r1);
            double mx = (a1 < a2 ? a1 : a2) + mod;
            double my = (b1 < b2 ? b1 : b2) + mod;
            s->object_pos[0] = wrap8(static_cast<long>(std::floor(mx)));
            s->object_pos[1] = wrap8(static_cast<long>(std::floor(my)));
        }
        s->object_dim[0] = w; s->object_dim[1] = h;
        repack_transform(s, kind, h, w);
    } else {
        // flips: the oracle/reference never updates object_dim here (the
        // D0/D1 variants transpose the buffer under unchanged dims — a
        // preserved quirk; shipped envs only use H/V)
        repack_transform(s, kind, h, w);
    }
    compose(s);
}

void op_copy(NativeState* s, const int8_t* sel, int from_input) {
    int r0, r1, c0, c1;
    bool any = false;
    for (int i = 0; i < s->H * s->W; ++i) if (sel[i] > 0) { any = true; break; }
    if (!any) return;
    if (!bbox(s, sel, &r0, &r1, &c0, &c1)) return;
    const int8_t* src = from_input ? s->input : s->grid;
    int sh = from_input ? s->input_dim[0] : s->grid_dim[0];
    int sw = from_input ? s->input_dim[1] : s->grid_dim[1];
    if (r1 > sh || c1 > sw) return;  // strictly greater: reference parity
    int h = r1 - r0 + 1, w = c1 - c0 + 1;
    zero_grid(s, s->clip);
    s->clip_dim[0] = h; s->clip_dim[1] = w;
    for (int r = 0; r < h; ++r)
        for (int c = 0; c < w; ++c) {
            int8_t v = src[idx(s, r0 + r, c0 + c)];
            if (v != 0 && sel[idx(s, r0 + r, c0 + c)] != 0)
                s->clip[idx(s, r, c)] = v;
        }
}

void op_paste(NativeState* s, const int8_t* sel, int blank) {
    int r0, r1, c0, c1;
    bool any = false;
    for (int i = 0; i < s->H * s->W; ++i) if (sel[i] > 0) { any = true; break; }
    if (!any) return;
    if (!bbox(s, sel, &r0, &r1, &c0, &c1)) return;
    int h = s->clip_dim[0], w = s->clip_dim[1];
    // clips to the frame (H, W), not grid_dim — reference parity
    if (r0 >= s->H || c0 >= s->W || h == 0 || w == 0) return;
    int ex = (r0 + h < s->H) ? r0 + h : s->H;
    int ey = (c0 + w < s->W) ? c0 + w : s->W;
    for (int r = r0; r < ex; ++r)
        for (int c = c0; c < ey; ++c) {
            int8_t p = s->clip[idx(s, r - r0, c - c0)];
            if (blank) s->grid[idx(s, r, c)] = p;
            else if (p > 0) s->grid[idx(s, r, c)] = p;
        }
}

void op_copy_from_input(NativeState* s) {
    s->grid_dim[0] = s->input_dim[0];
    s->grid_dim[1] = s->input_dim[1];
    std::memcpy(s->grid, s->input, static_cast<size_t>(s->H) * s->W);
}

void op_resize_grid(NativeState* s, const int8_t* sel) {
    int r0, r1, c0, c1;
    if (!bbox(s, sel, &r0, &r1, &c0, &c1)) return;
    zero_grid(s, s->grid);
    s->grid_dim[0] = r1 - r0 + 1;
    s->grid_dim[1] = c1 - c0 + 1;
}

void op_crop_grid(NativeState* s, const int8_t* sel) {
    int r0, r1, c0, c1;
    if (!bbox(s, sel, &r0, &r1, &c0, &c1)) return;
    int h = r1 - r0 + 1, w = c1 - c0 + 1;
    int8_t patch[MAXP];
    std::memset(patch, 0, sizeof(patch));
    for (int r = 0; r < h; ++r)
        for (int c = 0; c < w; ++c) {
            int gi = idx(s, r0 + r, c0 + c);
            if (sel[gi] != 0 && s->grid[gi] != 0)
                patch[r * w + c] = s->grid[gi];
        }
    zero_grid(s, s->grid);
    for (int r = 0; r < h; ++r)
        for (int c = 0; c < w; ++c)
            s->grid[idx(s, r, c)] = patch[r * w + c];
    s->grid_dim[0] = h; s->grid_dim[1] = w;
}

void op_resize_to_answer(NativeState* s) {
    int h = s->answer_dim[0], w = s->answer_dim[1];
    s->grid_dim[0] = h; s->grid_dim[1] = w;
    for (int r = 0; r < s->H; ++r)
        for (int c = 0; c < s->W; ++c)
            if (r >= h || c >= w) s->grid[idx(s, r, c)] = 0;
}

bool grid_matches_answer(const NativeState* s) {
    int h = s->grid_dim[0], w = s->grid_dim[1];
    if (h != s->answer_dim[0] || w != s->answer_dim[1]) return false;
    for (int r = 0; r < h; ++r)
        for (int c = 0; c < w; ++c)
            if (s->grid[idx(s, r, c)] != s->answer[idx(s, r, c)])
                return false;
    return true;
}

void reset_state(NativeState* s, const int8_t* input, int ih, int iw,
                 const int8_t* answer, int ah, int aw,
                 int max_trial, int reset_on_submit, int H, int W);

void op_submit(NativeState* s) {
    // base.py:172-183 ordering as transcribed by the oracle: the
    // trials==0 termination check lands on the state that existed before
    // any reset_on_submit replacement (and is then discarded with it)
    bool need_reset = false;
    if (s->trials_remain != 0) {
        s->trials_remain = static_cast<int8_t>(s->trials_remain - 1);
        s->submit_count += 1;
        if (grid_matches_answer(s)) s->terminated = 1;
        if (s->reset_on_submit) need_reset = true;
    }
    if (s->trials_remain == 0) s->terminated = 1;
    if (need_reset) {
        int8_t input_raw[MAXP], answer_raw[MAXP];
        int ih = s->input_dim[0], iw = s->input_dim[1];
        int ah = s->answer_dim[0], aw = s->answer_dim[1];
        for (int r = 0; r < ih; ++r)
            for (int c = 0; c < iw; ++c)
                input_raw[r * iw + c] = s->input[idx(s, r, c)];
        for (int r = 0; r < ah; ++r)
            for (int c = 0; c < aw; ++c)
                answer_raw[r * aw + c] = s->answer[idx(s, r, c)];
        int sc = s->submit_count, st = s->steps;
        reset_state(s, input_raw, ih, iw, answer_raw, ah, aw,
                    s->max_trial, 1, s->H, s->W);
        s->submit_count = sc;
        s->steps = st;
    }
}

void reset_state(NativeState* s, const int8_t* input, int ih, int iw,
                 const int8_t* answer, int ah, int aw,
                 int max_trial, int reset_on_submit, int H, int W) {
    std::memset(s, 0, sizeof(NativeState));
    s->H = H; s->W = W;
    for (int r = 0; r < ih; ++r)
        for (int c = 0; c < iw; ++c) {
            s->input[r * W + c] = input[r * iw + c];
            s->grid[r * W + c] = input[r * iw + c];
        }
    for (int r = 0; r < ah; ++r)
        for (int c = 0; c < aw; ++c)
            s->answer[r * W + c] = answer[r * aw + c];
    s->input_dim[0] = ih; s->input_dim[1] = iw;
    s->grid_dim[0] = ih; s->grid_dim[1] = iw;
    s->answer_dim[0] = ah; s->answer_dim[1] = aw;
    s->trials_remain = static_cast<int8_t>(max_trial);
    s->max_trial = max_trial;
    s->reset_on_submit = reset_on_submit;
    s->last_action_op = -1;
}

}  // namespace

extern "C" {

int engine_state_size() { return static_cast<int>(sizeof(NativeState)); }

void engine_reset(NativeState* s, const int8_t* input, int ih, int iw,
                  const int8_t* answer, int ah, int aw,
                  int max_trial, int reset_on_submit, int H, int W) {
    reset_state(s, input, ih, iw, answer, ah, aw, max_trial,
                reset_on_submit, H, W);
}

// One transition.  (grp, par, rs) is the op's OpTable row; is_submit_op
// marks the table's reward-checking submit index.  Returns terminated.
int engine_step(NativeState* s, const int8_t* sel, int grp, int par,
                int rs, int is_submit_op, float* reward_out) {
    if (rs) {  // reset_sel decorator (object.py:10-26)
        zero_grid(s, s->selected);
        s->active = 0;
    }
    switch (grp) {
        case G_COLOR: op_color(s, sel, par); break;
        case G_FLOOD: op_flood(s, sel, par); break;
        case G_OBJECT: op_object(s, sel, par); break;
        case G_COPY: op_copy(s, sel, par == 0 ? 1 : 0); break;
        case G_PASTE: op_paste(s, sel, par); break;
        case G_COPY_FROM_INPUT: op_copy_from_input(s); break;
        case G_RESET_GRID: zero_grid(s, s->grid); break;
        case G_RESIZE_GRID: op_resize_grid(s, sel); break;
        case G_CROP_GRID: op_crop_grid(s, sel); break;
        case G_SUBMIT: op_submit(s); break;
        case G_RESIZE_TO_ANSWER: op_resize_to_answer(s); break;
        default: break;
    }
    float reward = 0.0f;
    if (is_submit_op && grid_matches_answer(s)) reward = 1.0f;
    s->steps += 1;
    s->last_reward = reward;
    *reward_out = reward;
    return s->terminated ? 1 : 0;
}

// Batched driver for benchmarking / hot loops: steps one env through a
// whole action sequence without crossing the FFI per step.
// sels: [n, H*W] int8; ops rows (grp/par/rs/is_submit) each [n] int32.
// rewards_out: [n] float.  Returns number of steps executed (stops early
// only never — termination is the caller's policy, matching gym).
int engine_run(NativeState* s, const int8_t* sels, const int32_t* grp,
               const int32_t* par, const int32_t* rs,
               const int32_t* is_submit, int n, float* rewards_out,
               int8_t* terms_out) {
    int P = s->H * s->W;
    for (int i = 0; i < n; ++i) {
        float r = 0.0f;
        int t = engine_step(s, sels + static_cast<long>(i) * P, grp[i],
                            par[i], rs[i], is_submit[i], &r);
        rewards_out[i] = r;
        terms_out[i] = static_cast<int8_t>(t);
    }
    return n;
}

}  // extern "C"
