"""Dense building blocks shared by the model zoo.

Towers are plain matmuls that XLA hands to the matrix units;
``dtype=bfloat16`` gives the reference's BF16 mixed-precision mode
(``docs/BFloat16.md`` / ``keep_weights``): parameters stay float32,
activations compute in bf16, logits in float32.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp

from deeprec_tpu.layers import module as nn


class MLP(nn.Module):
    """Stack of Dense layers; the reference's DNN towers
    (e.g. ``modelzoo/WDL/train.py`` deep tower)."""

    units: Sequence[int]
    activation: Callable = nn.relu
    final_activation: Optional[Callable] = None
    dtype: Any = jnp.float32
    use_bias: bool = True

    @nn.compact
    def __call__(self, x):
        x = x.astype(self.dtype)
        for i, u in enumerate(self.units):
            x = nn.Dense(u, use_bias=self.use_bias, dtype=self.dtype,
                         name=f"dense_{i}")(x)
            if i < len(self.units) - 1:
                x = self.activation(x)
            elif self.final_activation is not None:
                x = self.final_activation(x)
        return x


class LogitsHead(nn.Module):
    """Final projection to logits in float32 (loss numerics stay fp32
    even in bf16 mode, matching the reference's keep-weights scheme)."""

    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = nn.Dense(1, dtype=jnp.float32,
                     name="logits")(x.astype(jnp.float32))
        return x[..., 0]


def fm_interaction(field_emb):
    """FM second-order interaction.

    field_emb: [B, F, D] — one embedding per field.
    Returns [B, D]: 0.5 * ((sum_f v)^2 - sum_f v^2), the classic
    O(F*D) factorization-machine identity (DeepFM's FM part,
    ``modelzoo/DeepFM/train.py``).
    """
    s = jnp.sum(field_emb, axis=1)
    sq = jnp.sum(jnp.square(field_emb), axis=1)
    return 0.5 * (jnp.square(s) - sq)


def dot_interaction(field_emb, self_interaction: bool = False):
    """DLRM pairwise dot interaction.

    field_emb: [B, F, D] -> [B, F*(F-1)/2] upper-triangular pairwise
    dots (``modelzoo/DLRM/train.py`` interact_features): one [B,F,D] x
    [B,D,F] batched matmul.
    """
    B, F, D = field_emb.shape
    z = jnp.einsum("bfd,bgd->bfg", field_emb, field_emb)
    k = 0 if self_interaction else 1
    iu = jnp.triu_indices(F, k=k)
    return z[:, iu[0], iu[1]]


class DINAttention(nn.Module):
    """DIN local activation unit (``modelzoo/DIN/train.py`` attention):
    per-position score from MLP([q, k, q-k, q*k]), masked softmax,
    weighted sum over the behavior sequence.
    """

    hidden: Sequence[int] = (80, 40)
    dtype: Any = jnp.float32
    use_softmax: bool = True

    @nn.compact
    def __call__(self, query, keys, mask):
        """query [B, D], keys [B, T, D], mask [B, T] -> [B, D]."""
        B, T, D = keys.shape
        q = jnp.broadcast_to(query[:, None, :], (B, T, D))
        feats = jnp.concatenate([q, keys, q - keys, q * keys], axis=-1)
        score = MLP(units=tuple(self.hidden) + (1,), dtype=self.dtype,
                    name="att_mlp")(feats)[..., 0]  # [B, T]
        score = score.astype(jnp.float32)
        neg = jnp.finfo(jnp.float32).min
        score = jnp.where(mask, score, neg)
        if self.use_softmax:
            w = jax.nn.softmax(score / jnp.sqrt(jnp.float32(D)), axis=1)
        else:
            w = jnp.where(mask, jax.nn.sigmoid(score), 0.0)
        return jnp.einsum("bt,btd->bd", w.astype(keys.dtype), keys)


class GRU(nn.Module):
    """Plain GRU over a sequence via lax.scan (DIEN interest extractor,
    ``modelzoo/DIEN/train.py``)."""

    hidden: int
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, mask):
        """x [B, T, D], mask [B, T] -> (outputs [B, T, H], final [B, H])."""
        B, T, D = x.shape
        H = self.hidden
        dt = self.dtype
        # Fused gate weights: one [D, 3H] and one [H, 3H] matmul per step.
        wi = self.param("wi", nn.initializers.xavier_uniform(), (D, 3 * H))
        wh = self.param("wh", nn.initializers.orthogonal(), (H, 3 * H))
        b = self.param("b", nn.initializers.zeros, (3 * H,))
        h0 = jnp.zeros((B, H), dt)

        def step(h, inp):
            xt, mt = inp
            gi = xt.astype(dt) @ wi.astype(dt) + b.astype(dt)
            gh = h @ wh.astype(dt)
            z = jax.nn.sigmoid(gi[:, :H] + gh[:, :H])
            r = jax.nn.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
            hh = jnp.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
            hn = (1 - z) * h + z * hh
            hn = jnp.where(mt[:, None], hn, h)
            return hn, jnp.where(mt[:, None], hn, jnp.zeros_like(hn))

        xs = jnp.moveaxis(x, 1, 0)                          # [T, B, D]
        ms = jnp.moveaxis(mask, 1, 0)                       # [T, B]
        final, outs = jax.lax.scan(step, h0, (xs, ms))
        return jnp.moveaxis(outs, 0, 1), final


class AUGRU(nn.Module):
    """Attention-update GRU (DIEN interest evolution): the update gate
    is scaled by a per-step attention score.  The recurrence is one
    ``lax.scan`` (SURVEY §7 hard-parts note).
    """

    hidden: int
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, att, mask):
        """x [B, T, D], att [B, T], mask [B, T] -> final state [B, H]."""
        B, T, D = x.shape
        H = self.hidden
        dt = self.dtype
        wz = self.param("wz", nn.initializers.xavier_uniform(), (D, H))
        uz = self.param("uz", nn.initializers.orthogonal(), (H, H))
        bz = self.param("bz", nn.initializers.zeros, (H,))
        wr = self.param("wr", nn.initializers.xavier_uniform(), (D, H))
        ur = self.param("ur", nn.initializers.orthogonal(), (H, H))
        br = self.param("br", nn.initializers.zeros, (H,))
        wh = self.param("wh", nn.initializers.xavier_uniform(), (D, H))
        uh = self.param("uh", nn.initializers.orthogonal(), (H, H))
        bh = self.param("bh", nn.initializers.zeros, (H,))

        def step(h, inp):
            xt, at, mt = inp
            xt = xt.astype(dt)
            z = jax.nn.sigmoid(xt @ wz.astype(dt) + h @ uz.astype(dt)
                               + bz.astype(dt))
            r = jax.nn.sigmoid(xt @ wr.astype(dt) + h @ ur.astype(dt)
                               + br.astype(dt))
            hh = jnp.tanh(xt @ wh.astype(dt) + (r * h) @ uh.astype(dt)
                          + bh.astype(dt))
            z = at[:, None].astype(dt) * z  # attentional update gate
            hn = (1 - z) * h + z * hh
            return jnp.where(mt[:, None], hn, h), None

        h0 = jnp.zeros((B, H), dt)
        xs = jnp.moveaxis(x, 1, 0)
        ats = jnp.moveaxis(att, 1, 0)
        ms = jnp.moveaxis(mask, 1, 0)
        final, _ = jax.lax.scan(step, h0, (xs, ats, ms))
        return final


class TransformerBlock(nn.Module):
    """Post-norm transformer encoder block (BST,
    ``modelzoo/BST/train.py``): MHA over the behavior sequence + FFN."""

    num_heads: int = 2
    ff_mult: int = 4
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, mask):
        """x [B, T, D], mask [B, T] -> [B, T, D]."""
        D = x.shape[-1]
        attn_mask = mask[:, None, None, :]  # broadcast over heads+query
        h = nn.MultiHeadDotProductAttention(
            num_heads=self.num_heads, dtype=self.dtype, name="mha")(
                x.astype(self.dtype), x.astype(self.dtype),
                mask=attn_mask)
        x = nn.LayerNorm(dtype=jnp.float32, name="ln1")(x + h)
        f = MLP(units=(D * self.ff_mult, D), dtype=self.dtype,
                name="ffn")(x)
        x = nn.LayerNorm(dtype=jnp.float32, name="ln2")(x + f)
        return x * mask[..., None].astype(x.dtype)
