"""GPT policy network (flax).

Re-design of the reference transformer policy
(/root/reference/agents/models/GPTPolicy.py): tokens = 900 grid cells +
900 input cells + 1 info token + n_ops operation tokens + 1 CLS
(GPTPolicy.py:363-381), self-attention with key-padding masks over the
inactive grid area, and heads for operation logits (per-op token),
bbox mean/std, critic, and the auxiliary r_{t-1} / r_t / next-grid
predictions (GPTPolicy.py:191-201).

Differences: masks are computed directly with iota arithmetic instead of
the reference's ``affine_grid``/``grid_sample`` translation trick
(GPTPolicy.py:291-327) — bit-identical active areas without image
resampling; attention runs in bfloat16 with f32 accumulation.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp

from .gpt_config import GPTConfig


def active_mask(dim: jax.Array, H: int, W: int) -> jax.Array:
    """Bool [H*W]: cells inside ``dim`` (the reference's compute_mask for
    origin-anchored fields, GPTPolicy.py:291-304)."""
    rows = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    d = dim.astype(jnp.int32)
    return ((rows < d[0]) & (cols < d[1])).reshape(-1)


def _streaming_attention(q, k, v, pad_mask, chunk: int = 512):
    """Exact softmax attention without materializing the [T, T] matrix:
    online-softmax accumulation over key/value chunks (flash-attention
    recurrence).  Needed for the 1837-token observation sequence — dense
    attention is O(B*H*T^2) floats (~1.4 TB for one PPO batch).

    q, k, v: [B, T, H, D]; pad_mask: [B, T] bool, True = masked key.
    Returns [B, T, H, D] in f32.
    """
    B, T, Hh, D = q.shape
    scale = 1.0 / jnp.sqrt(jnp.asarray(D, jnp.float32))
    Tp = ((T + chunk - 1) // chunk) * chunk
    pad = Tp - T
    kp = jnp.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
    vp = jnp.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
    mp = jnp.pad(pad_mask, ((0, 0), (0, pad)), constant_values=True)
    nc = Tp // chunk
    kc = kp.reshape(B, nc, chunk, Hh, D).transpose(1, 0, 2, 3, 4)
    vc = vp.reshape(B, nc, chunk, Hh, D).transpose(1, 0, 2, 3, 4)
    mc = mp.reshape(B, nc, chunk).transpose(1, 0, 2)

    qh = q.transpose(0, 2, 1, 3)          # [B, H, T, D]

    # checkpoint each chunk: without it, scan AD stores the [B,H,T,chunk]
    # score/probability tensors for EVERY chunk before the backward pass
    # (tens of GB at the full batch) — recomputing them per chunk keeps
    # the backward at the same transient footprint as the forward
    @jax.checkpoint
    def chunk_update(carry, k_c, v_c, mask_c):
        m, l, acc = carry
        s = jnp.einsum("bhqd,bkhd->bhqk", qh, k_c,
                       preferred_element_type=jnp.float32) * scale
        s = jnp.where(mask_c[:, None, None, :], -1e30, s)
        m_new = jnp.maximum(m, s.max(-1))
        alpha = jnp.exp(m - m_new)
        p = jnp.exp(s - m_new[..., None])
        l_new = l * alpha + p.sum(-1)
        acc_new = acc * alpha[..., None] + jnp.einsum(
            "bhqk,bkhd->bhqd", p.astype(q.dtype), v_c,
            preferred_element_type=jnp.float32)
        return (m_new, l_new, acc_new)

    def body(carry, xs):
        k_c, v_c, mask_c = xs
        return chunk_update(carry, k_c, v_c, mask_c), None

    init = (jnp.full((B, Hh, T), -1e30, jnp.float32),
            jnp.zeros((B, Hh, T), jnp.float32),
            jnp.zeros((B, Hh, T, D), jnp.float32))
    (m, l, acc), _ = jax.lax.scan(body, init, (kc, vc, mc))
    out = acc / l[..., None]
    return out.transpose(0, 2, 1, 3)      # [B, T, H, D]


class SelfAttention(nn.Module):
    cfg: GPTConfig

    @nn.compact
    def __call__(self, x, pad_mask, deterministic=True):
        c = self.cfg
        B, T, C = x.shape
        qkv = nn.Dense(3 * C, dtype=c.dtype, name="qkv")(x)
        q, k, v = jnp.split(qkv, 3, axis=-1)
        split = lambda a: a.reshape(B, T, c.n_head, C // c.n_head)
        q, k, v = split(q), split(k), split(v)
        dense_bytes = 4 * B * c.n_head * T * T
        if T >= 1024 and dense_bytes > c.dense_attn_budget:
            # streaming path (no dropout inside attention probabilities;
            # reference uses attn_pdrop=0.1 but PPO runs deterministic)
            y = _streaming_attention(q, k, v, pad_mask, chunk=c.attn_chunk)
        else:
            att = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                             preferred_element_type=jnp.float32)
            att = att / jnp.sqrt(jnp.asarray(C // c.n_head, jnp.float32))
            # key-padding mask: True = masked out (GPTPolicy.py:83)
            att = jnp.where(pad_mask[:, None, None, :], -jnp.inf, att)
            att = jax.nn.softmax(att, axis=-1)
            att = nn.Dropout(c.attn_pdrop)(att, deterministic=deterministic)
            y = jnp.einsum("bhqk,bkhd->bqhd", att.astype(c.dtype), v,
                           preferred_element_type=jnp.float32)
        y = y.reshape(B, T, C).astype(c.dtype)
        y = nn.Dense(C, dtype=c.dtype, name="proj")(y)
        return nn.Dropout(c.resid_pdrop)(y, deterministic=deterministic)


class Block(nn.Module):
    cfg: GPTConfig

    @nn.compact
    def __call__(self, x, pad_mask, deterministic=True):
        c = self.cfg
        x = x + SelfAttention(c)(nn.LayerNorm(dtype=c.dtype)(x), pad_mask,
                                 deterministic)
        h = nn.Dense(4 * c.n_embd, dtype=c.dtype)(nn.LayerNorm(dtype=c.dtype)(x))
        h = nn.gelu(h)
        h = nn.Dense(c.n_embd, dtype=c.dtype)(h)
        h = nn.Dropout(c.resid_pdrop)(h, deterministic=deterministic)
        return x + h


class Periodic(nn.Module):
    """Random-Fourier-feature bbox encoder (GPTPolicy.py:115-126):
    x -> [cos(2*pi*c*x), sin(2*pi*c*x)] -> Dense -> GELU, with learnable
    per-coordinate frequencies drawn N(0, sigma)."""

    n_freq: int
    out: int
    sigma: float = 0.15
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x):              # [..., D] floats in [0, 1]
        coef = self.param("coefficients",
                          nn.initializers.normal(self.sigma),
                          (x.shape[-1], self.n_freq))
        ang = 2 * jnp.pi * coef * x[..., None].astype(jnp.float32)
        feat = jnp.concatenate([jnp.cos(ang), jnp.sin(ang)], -1)
        feat = feat.reshape(*x.shape[:-1], -1).astype(self.dtype)
        return nn.gelu(nn.Dense(self.out, dtype=self.dtype,
                                name="encoder")(feat))


class Head(nn.Module):
    """3-layer GELU head (GPTPolicy.py head_factory)."""

    out: int
    cfg: GPTConfig

    @nn.compact
    def __call__(self, x):
        c = self.cfg
        x = nn.gelu(nn.Dense(c.n_embd, dtype=c.dtype,
                             kernel_init=nn.initializers.orthogonal(jnp.sqrt(2)))(x))
        x = nn.gelu(nn.Dense(c.n_embd, dtype=c.dtype,
                             kernel_init=nn.initializers.orthogonal(jnp.sqrt(2)))(x))
        return nn.Dense(self.out, dtype=jnp.float32,
                        kernel_init=nn.initializers.orthogonal(0.01))(x)


class GPTPolicy(nn.Module):
    """Returns per-op tokens, op logits, value, and aux predictions."""

    cfg: GPTConfig = GPTConfig()

    @nn.compact
    def __call__(self, grid, grid_dim, inp, inp_dim, trials_remain, active,
                 deterministic: bool = True, operation=None, bbox=None):
        """All args batched: grid/inp i8 [B,H,W]; dims i8 [B,2];
        trials_remain/active i8 [B].

        ``operation`` (i32 [B]) and ``bbox`` (f32 [B,4] in [0,1]) switch on
        the *action-conditioned* pass: the chosen operation's embedding and
        a Periodic encoding of the bbox are appended as two extra tokens
        after CLS (the reference's two-pass ``act``/``evaluate`` intent,
        GPTPolicy.py:401-456 with ``additional_tokens=[enc_op, enc_bb]``;
        note the shipped reference assembles but never appends them —
        GPTPolicy.py:380-381 ignores ``additional_tokens`` — so this
        implements the design the paper's aux losses require).  In this
        mode ``aux_reward`` reads from the final action token and
        ``aux_transition`` from the (action-attending) grid tokens."""
        c = self.cfg
        B = grid.shape[0]
        P = c.num_pixel
        conditioned = operation is not None

        color_emb = nn.Embed(c.num_colors, c.n_embd, dtype=c.dtype,
                             name="color_encoder")
        pos_emb = self.param("pos_emb", nn.initializers.normal(0.02),
                             (1, P, c.n_embd))
        state_emb = self.param("state_emb", nn.initializers.normal(0.02),
                               (8, 1, c.n_embd))
        cls_tkn = self.param("cls_tkn", nn.initializers.normal(0.02),
                             (1, 1, c.n_embd))
        color_action_tkn = self.param("color_action_tkn",
                                      nn.initializers.normal(0.02),
                                      (1, 1, c.n_embd))
        op_emb = nn.Embed(c.num_actions, c.n_embd, dtype=c.dtype,
                          name="operation_encoder")
        trials_emb = nn.Embed(4, c.n_embd, dtype=c.dtype,
                              name="trials_encoder")
        active_emb = nn.Embed(2, c.n_embd, dtype=c.dtype,
                              name="active_encoder")

        pe = pos_emb.astype(c.dtype)
        grid_t = color_emb(jnp.clip(grid, 0, c.num_colors - 1).astype(jnp.int32)
                           .reshape(B, P)) + pe + state_emb[0].astype(c.dtype)
        inp_t = color_emb(jnp.clip(inp, 0, c.num_colors - 1).astype(jnp.int32)
                          .reshape(B, P)) + pe + state_emb[6].astype(c.dtype)

        info = (trials_emb(jnp.clip(trials_remain, 0, 3).astype(jnp.int32))
                + active_emb(jnp.clip(active, 0, 1).astype(jnp.int32)))
        info = info.reshape(B, 1, c.n_embd)

        op_tokens = jnp.tile(op_emb.embedding[None].astype(c.dtype), (B, 1, 1))
        color_part = (color_action_tkn.astype(c.dtype)
                      + color_emb.embedding[None].astype(c.dtype))
        if c.color_equivariant:
            # §4.1.2: the color-op token is a *function of the color
            # embedding* only — replacing (not augmenting) the learned
            # per-op embedding makes the policy exactly equivariant under
            # simultaneous (task colors, color-emb rows) permutation
            op_tokens = op_tokens.at[:, :c.num_colors].set(
                jnp.broadcast_to(color_part,
                                 (B, c.num_colors, c.n_embd)))
        else:
            op_tokens = op_tokens.at[:, :c.num_colors].add(color_part)

        cls = jnp.tile(cls_tkn.astype(c.dtype), (B, 1, 1))

        # action-embedding tokens; the encoder params are materialized in
        # every call mode so a single init covers both passes
        bbox_enc = Periodic(n_freq=max(c.n_embd // 8, 1), out=c.n_embd,
                            dtype=c.dtype, name="bbox_encoder")
        op_cond = operation if conditioned else jnp.zeros((B,), jnp.int32)
        bb_cond = bbox if conditioned else jnp.zeros((B, 4), jnp.float32)
        enc_op = op_emb(op_cond.astype(jnp.int32))[:, None]
        if c.color_equivariant:
            # keep the conditioned pass equivariant too: a color op's
            # action token is the same function of the color embedding
            # as its policy token
            color_cond = (color_action_tkn[0].astype(c.dtype)
                          + color_emb(jnp.clip(op_cond, 0,
                                               c.num_colors - 1)
                                      .astype(jnp.int32))[:, None])
            enc_op = jnp.where((op_cond < c.num_colors)[:, None, None],
                               color_cond, enc_op)
        enc_bb = bbox_enc(bb_cond)[:, None]

        tokens = [grid_t, inp_t, info, op_tokens, cls]
        n_special = 0
        if c.factorized:
            opq_tkn = self.param("op_query_tkn",
                                 nn.initializers.normal(0.02),
                                 (1, 1, c.n_embd))
            selq_tkn = self.param("sel_query_tkn",
                                  nn.initializers.normal(0.02),
                                  (1, 1, c.n_embd))
            tokens += [jnp.tile(opq_tkn.astype(c.dtype), (B, 1, 1)),
                       jnp.tile(selq_tkn.astype(c.dtype), (B, 1, 1))]
            n_special = 2
        n_extra = 0
        if conditioned:
            tokens += [enc_op, enc_bb]
            n_extra = 2
        x = jnp.concatenate(tokens, axis=1)

        grid_pad = ~jax.vmap(active_mask, in_axes=(0, None, None))(
            grid_dim, c.grid_x, c.grid_y)
        inp_pad = ~jax.vmap(active_mask, in_axes=(0, None, None))(
            inp_dim, c.grid_x, c.grid_y)
        fixed = jnp.zeros((B, 2 + c.num_actions + n_special + n_extra),
                          bool)
        pad_mask = jnp.concatenate([grid_pad, inp_pad, fixed], axis=1)

        x = nn.Dropout(c.embd_pdrop)(x, deterministic=deterministic)
        block_cls = nn.remat(Block, static_argnums=(3,)) if c.remat else Block
        for i in range(c.n_layer):
            x = block_cls(c, name=f"block_{i}")(x, pad_mask, deterministic)
        x = nn.LayerNorm(dtype=c.dtype, name="ln_f")(x)

        # token slots by absolute position (stable under appended action
        # tokens): grid [0,P), input [P,2P), info 2P, ops, CLS, extras
        ops_at = 2 * P + 1
        cls_at = ops_at + c.num_actions
        op_x = x[:, ops_at:cls_at]
        cls_x = x[:, cls_at]
        grid_x_tokens = x[:, :P]
        # conditioned pass: r_t reads from the final action token
        # (GPTPolicy.py:423-425 intent); unconditioned: from CLS
        r_src = x[:, -1] if conditioned else cls_x

        bbox_logits_all = None
        if c.factorized:
            # non-sequential control (§4.1.2 arch (1)): operation logits
            # and a single op-independent bbox head from two dedicated
            # special tokens — (operation ⫫ selection) | s by construction
            opq_x = x[:, cls_at + 1]
            selq_x = x[:, cls_at + 2]
            op_logits = Head(c.num_actions, c, name="head_operation_f")(opq_x)
            bm = Head(4, c, name="head_bbox_mean_f")(selq_x)
            bs = Head(4, c, name="head_bbox_std_f")(selq_x)
            bbox_mean_all = jnp.broadcast_to(
                bm[:, None, :], (B, c.num_actions, 4))
            bbox_std_all = jnp.broadcast_to(
                bs[:, None, :], (B, c.num_actions, 4))
            if c.bbox_bins:
                bl = Head(4 * c.bbox_bins, c,
                          name="head_bbox_logits_f")(selq_x)
                bbox_logits_all = jnp.broadcast_to(
                    bl.reshape(B, 1, 4, c.bbox_bins),
                    (B, c.num_actions, 4, c.bbox_bins))
        else:
            op_logits = Head(1, c, name="head_operation")(op_x).squeeze(-1)
            bbox_mean_all = Head(4, c, name="head_bbox_mean")(op_x)
            bbox_std_all = Head(4, c, name="head_bbox_std")(op_x)
            if c.bbox_bins:
                bbox_logits_all = Head(
                    4 * c.bbox_bins, c, name="head_bbox_logits")(op_x) \
                    .reshape(B, -1, 4, c.bbox_bins)
        value = Head(1, c, name="head_critic")(cls_x).squeeze(-1)
        rtm1 = Head(1, c, name="head_aux_rtm1")(cls_x).squeeze(-1)
        r_pred = Head(1, c, name="head_aux_reward")(r_src).squeeze(-1)
        g_pred = Head(c.num_colors, c, name="head_aux_transition")(grid_x_tokens)

        out = {
            "op_tokens": op_x.astype(jnp.float32),
            "op_logits": op_logits.astype(jnp.float32),
            "value": value,
            "aux_rtm1": rtm1,
            "aux_reward": r_pred,
            "aux_transition": g_pred,
            "bbox_mean_all": bbox_mean_all,
            "bbox_std_all": bbox_std_all,
        }
        if bbox_logits_all is not None:
            out["bbox_logits_all"] = bbox_logits_all.astype(jnp.float32)
        return out
