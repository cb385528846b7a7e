"""GPT policy configuration, importable without flax (the run config
embeds it; only :mod:`.gpt` builds the network)."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Mirror of gptconfig.yaml / train_gpt.py:65-80."""

    grid_x: int = 30
    grid_y: int = 30
    num_colors: int = 10
    num_actions: int = 35
    n_layer: int = 8
    n_head: int = 16
    n_embd: int = 128
    embd_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    dtype: jnp.dtype = jnp.bfloat16
    remat: bool = True          # rematerialize blocks (long sequences)
    color_equivariant: bool = False  # paper §4.1.2 color-equivariant arch:
                                # color-op tokens are *pure* functions of
                                # the color embedding (no per-op learned
                                # embedding), so permuting task colors +
                                # color-emb rows permutes the policy exactly
    factorized: bool = False    # paper §4.1.2 "non-sequential" control:
                                # operation and selection decided from two
                                # independent special tokens (assumes
                                # operation ⫫ selection | s)
    bbox_bins: int = 0          # >0: additionally emit categorical bbox
                                # coordinate logits [n_ops, 4, bins] — the
                                # discrete selection head used by the
                                # answer-given benchmark (small grids);
                                # 0 = TruncatedNormal heads only (the
                                # reference AROPandBBox parameterization)
    attn_chunk: int = 512       # streaming-attention key-chunk size; the
                                # per-chunk score tensor is
                                # [B, H, T, attn_chunk] f32 — shrink for
                                # large-batch training (e.g. 256 for the
                                # E-MAML 100-sample task batches)
    dense_attn_budget: int = 0  # bytes: use one dense [B,H,T,T] f32
                                # score tensor when it fits this budget,
                                # else the streaming recurrence (default:
                                # always stream at T>=1024); the same
                                # exact softmax either way (equivalence
                                # is tested).  Which is faster on the GPU
                                # is not measured

    @property
    def num_pixel(self) -> int:
        return self.grid_x * self.grid_y

    @property
    def num_tokens(self) -> int:
        # grid + input + info + op tokens + cls (GPTPolicy.py:380-381)
        return 2 * self.num_pixel + 1 + self.num_actions + 1
