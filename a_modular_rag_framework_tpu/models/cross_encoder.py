"""Cross-encoder reranker — the rerank stage of BASELINE config 4.

Joint (query, passage) relevance: both texts share ONE sequence with
segment embeddings, so attention crosses between them, and a scalar head
scores the pair. This is the capability class the reference lacks
entirely — its "dense rerank" is a bi-encoder cosine over independently
embedded texts (/root/reference/app/modules/retrieval/retrieval_backend.py:186-247)
— and is the standard second stage over a candidate pool the hybrid
engine produces.

Device shape discipline: a rerank call scores ``B`` queries x ``M``
candidates as ONE ``[B*M, L]`` batch through the transformer (bf16
matmuls, f32 accumulation), chunked to a fixed pair budget so
bucket reuse keeps the program cache small. Reuses the flagship
encoder's tokenizer/blocks (`models/encoder.py`) so subword-feature
transfer behavior is shared.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .encoder import (
    EncoderConfig,
    _attention,
    _layer_norm,
    encode_tokens,
    init_params,
)


@dataclass(frozen=True)
class CrossEncoderConfig(EncoderConfig):
    """Encoder hyperparameters + pair-packing policy."""

    max_query_len: int = 20  # query tokens before the passage starts


# ---------------- params ----------------


def init_cross_params(rng: jax.Array, cfg: CrossEncoderConfig) -> Dict[str, Any]:
    k_base, k_seg, k_head = jax.random.split(rng, 3)
    params = init_params(k_base, cfg)
    scale = cfg.d_model ** -0.5
    params["seg_emb"] = jax.random.normal(k_seg, (2, cfg.d_model)) * scale
    params["w_score"] = jax.random.normal(k_head, (cfg.d_model,)) * scale
    params["b_score"] = jnp.zeros(())
    return params


# ---------------- host featurization ----------------


def encode_pairs(queries: Sequence[str], passages: Sequence[str],
                 cfg: CrossEncoderConfig
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (ids [N, L] or [N, L, G], mask f32 [N, L], seg int32 [N, L]).

    The query occupies the first ``max_query_len`` positions, the passage
    the rest; segment ids 0/1 tell the model which is which (there is no
    [SEP] vocabulary entry — the segment embedding carries the boundary).
    """
    assert len(queries) == len(passages)
    L, Lq = cfg.max_len, cfg.max_query_len
    q_ids, q_mask = encode_tokens(list(queries), cfg)
    p_ids, p_mask = encode_tokens(list(passages), cfg)
    N = len(queries)
    ids = np.zeros_like(q_ids)
    mask = np.zeros((N, L), dtype=np.float32)
    seg = np.zeros((N, L), dtype=np.int32)
    ids[:, :Lq] = q_ids[:, :Lq]
    mask[:, :Lq] = q_mask[:, :Lq]
    Lp = L - Lq
    ids[:, Lq:] = p_ids[:, :Lp]
    mask[:, Lq:] = p_mask[:, :Lp]
    seg[:, Lq:] = 1
    return ids, mask, seg


# ---------------- forward ----------------


def apply_cross_encoder(params: Dict[str, Any], token_ids: jax.Array,
                        mask: jax.Array, seg: jax.Array,
                        cfg: CrossEncoderConfig) -> jax.Array:
    """(ids, mask, seg) [N, L] -> relevance logits [N] f32."""
    x = jnp.take(params["tok_emb"], token_ids, axis=0)
    if token_ids.ndim == 3:  # mean over subword features per word
        x = jnp.mean(x, axis=2)
    x = x + params["pos_emb"][None, : mask.shape[1], :]
    x = x + jnp.take(params["seg_emb"], seg, axis=0)
    x = x.astype(jnp.float32)
    for layer in params["layers"]:
        h = _layer_norm(x, layer["ln1"]["g"], layer["ln1"]["b"])
        x = x + _attention(h, layer["wqkv"], layer["wo"], mask,
                           cfg.n_heads, cfg.dtype, cfg.attn_dtype)
        h = _layer_norm(x, layer["ln2"]["g"], layer["ln2"]["b"])
        h = jnp.dot(h.astype(cfg.dtype), layer["w1"].astype(cfg.dtype),
                    preferred_element_type=jnp.float32)
        h = jax.nn.gelu(h)
        h = jnp.dot(h.astype(cfg.dtype), layer["w2"].astype(cfg.dtype),
                    preferred_element_type=jnp.float32)
        x = x + h
    x = _layer_norm(x, params["out_ln"]["g"], params["out_ln"]["b"])
    m = mask[:, :, None]
    pooled = jnp.sum(x * m, axis=1) / jnp.maximum(jnp.sum(m, axis=1), 1e-6)
    return jnp.dot(pooled, params["w_score"]) + params["b_score"]


# ---------------- training ----------------


def listwise_loss(params, batch, cfg: CrossEncoderConfig):
    """Softmax CE over each query's M candidates (label = positive's
    slot). batch: ids/mask/seg [B, M, ...], label int32 [B]."""
    B, M = batch["label"].shape[0], batch["ids"].shape[1]
    flat = lambda a: a.reshape((B * M,) + a.shape[2:])  # noqa: E731
    logits = apply_cross_encoder(
        params, flat(batch["ids"]), flat(batch["mask"]), flat(batch["seg"]),
        cfg).reshape(B, M)
    loss = jnp.mean(-jax.nn.log_softmax(logits, axis=-1)[
        jnp.arange(B), batch["label"]])
    acc = jnp.mean(
        (jnp.argmax(logits, axis=-1) == batch["label"]).astype(jnp.float32))
    return loss, acc


def make_cross_train_step(cfg: CrossEncoderConfig, learning_rate: float = 1e-3):
    import optax

    tx = optax.adamw(learning_rate)

    def init_state(params):
        return tx.init(params)

    def train_step(params, opt_state, batch):
        (loss, acc), grads = jax.value_and_grad(
            lambda p: listwise_loss(p, batch, cfg), has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "accuracy": acc}

    return init_state, train_step


# ---------------- inference wrapper ----------------


class CrossEncoderReranker:
    """Scores (query, passage) pairs on device; reranks candidate lists.

    ``pair_budget`` bounds one program invocation ([budget, L] bucket) so
    arbitrary B*M chunk into a small set of compiled shapes.
    """

    def __init__(self, cfg: Optional[CrossEncoderConfig] = None, params=None,
                 seed: int = 0, pair_budget: int = 4096):
        self.cfg = cfg or CrossEncoderConfig()
        if params is None:
            params = init_cross_params(jax.random.PRNGKey(seed), self.cfg)
        self.params = params
        self.pair_budget = int(pair_budget)
        self._apply = jax.jit(
            functools.partial(apply_cross_encoder, cfg=self.cfg))

    def score_pairs(self, queries: Sequence[str],
                    passages: Sequence[str]) -> np.ndarray:
        """-> relevance logits [N] f32 (higher = more relevant)."""
        N = len(queries)
        if N == 0:
            return np.zeros((0,), dtype=np.float32)
        ids, mask, seg = encode_pairs(queries, passages, self.cfg)
        out = np.empty((N,), dtype=np.float32)
        step = self.pair_budget
        for a in range(0, N, step):
            b = min(N, a + step)
            n = b - a
            # pad the tail chunk to the budget so ONE bucket serves all
            pad = step - n if (N > step and n < step) else 0
            sl = slice(a, b)
            ids_c = np.concatenate([ids[sl], np.zeros_like(ids[:pad])]) \
                if pad else ids[sl]
            mask_c = np.concatenate([mask[sl], np.zeros_like(mask[:pad])]) \
                if pad else mask[sl]
            seg_c = np.concatenate([seg[sl], np.zeros_like(seg[:pad])]) \
                if pad else seg[sl]
            logits = np.asarray(self._apply(
                self.params, jnp.asarray(ids_c), jnp.asarray(mask_c),
                jnp.asarray(seg_c)))
            out[sl] = logits[:n]
        return out

    def rerank(self, query: str, passages: Sequence[str],
               top_m: Optional[int] = None) -> List[int]:
        """-> candidate indices reordered by model relevance (desc,
        ties by original rank). ``top_m`` limits scoring to the first m
        candidates; the tail keeps its original order after them."""
        m = len(passages) if top_m is None else min(top_m, len(passages))
        if m == 0:
            return list(range(len(passages)))
        scores = self.score_pairs([query] * m, list(passages[:m]))
        head = sorted(range(m), key=lambda i: (-scores[i], i))
        return head + list(range(m, len(passages)))

    def rerank_batch(self, queries: Sequence[str],
                     cand_texts: Sequence[Sequence[str]],
                     ) -> List[List[int]]:
        """Batched rerank: B queries x per-query candidate lists scored
        as one flattened pair stream (chunked by pair_budget)."""
        flat_q: List[str] = []
        flat_p: List[str] = []
        offsets = [0]
        for q, cands in zip(queries, cand_texts):
            flat_q.extend([q] * len(cands))
            flat_p.extend(cands)
            offsets.append(len(flat_p))
        scores = self.score_pairs(flat_q, flat_p)
        orders = []
        for bi in range(len(queries)):
            s = scores[offsets[bi]:offsets[bi + 1]]
            orders.append(sorted(range(len(s)), key=lambda i: (-s[i], i)))
        return orders

    # ---- persistence (same keystr scheme as TextEncoder) ----

    def save(self, path: str) -> None:
        flat, _ = jax.tree_util.tree_flatten_with_path(self.params)
        np.savez(path, **{jax.tree_util.keystr(k): np.asarray(v)
                          for k, v in flat})

    @classmethod
    def load(cls, path: str, cfg: Optional[CrossEncoderConfig] = None,
             **kw) -> "CrossEncoderReranker":
        cfg = cfg or CrossEncoderConfig()
        data = np.load(path)
        template = init_cross_params(jax.random.PRNGKey(0), cfg)
        flat, treedef = jax.tree_util.tree_flatten_with_path(template)
        leaves = []
        for k, v in flat:
            key = jax.tree_util.keystr(k)
            if key not in data:
                raise KeyError(f"missing weight {key} in {path}")
            arr = data[key]
            if arr.shape != np.asarray(v).shape:
                raise ValueError(
                    f"shape mismatch for {key}: {arr.shape} vs "
                    f"{np.asarray(v).shape} — check CrossEncoderConfig")
            leaves.append(jnp.asarray(arr))
        return cls(cfg, params=jax.tree_util.tree_unflatten(treedef, leaves),
                   **kw)

    # ---- training batch helper ----

    @staticmethod
    def make_listwise_batch(queries: Sequence[str],
                            cand_lists: Sequence[Sequence[str]],
                            labels: Sequence[int],
                            cfg: CrossEncoderConfig) -> Dict[str, np.ndarray]:
        """ids/mask/seg [B, M, ...] + label [B]; every list must share M."""
        B = len(queries)
        M = len(cand_lists[0])
        assert all(len(c) == M for c in cand_lists)
        flat_q = [q for q, c in zip(queries, cand_lists) for _ in c]
        flat_p = [p for c in cand_lists for p in c]
        ids, mask, seg = encode_pairs(flat_q, flat_p, cfg)
        return {
            "ids": ids.reshape((B, M) + ids.shape[1:]),
            "mask": mask.reshape(B, M, -1),
            "seg": seg.reshape(B, M, -1),
            "label": np.asarray(labels, dtype=np.int32),
        }
