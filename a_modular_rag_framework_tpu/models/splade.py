"""SPLADE-style learned sparse expansion head (pure JAX).

BASELINE config 4 names the sparse channel "BM25/SPLADE": the reference
ships only BM25 (`app/modules/retrieval/text_index.py`); this is the
learned-sparse alternative — a term-expansion model that scores documents
through the SAME impact-sorted CSR posting machinery as the BM25 channel
(`ops/bm25.bm25_topk_sorted` with per-term query weights), so the sparse
retrieval path is swappable between a lexical and a learned scorer.

Model: the flagship encoder's transformer trunk (`models.encoder.
encode_hidden` — shared matmuls, shared subword hashing, so transfer
behavior matches the dense head) followed by an MLM-style expansion head
tied to the token embedding, plus a learned lexical prior:

    t      = LayerNorm(gelu(h @ W_t))            # [B, L, D]
    logits = t @ tok_emb^T + bias                # [B, L, V]
    logits[l, own-token buckets of position l] += b0 * lex_w[bucket]
    w(v)   = max_l  mask_l * log1p(relu(logits)) # SPLADE-max pooling

`lex_w` is a learnable per-bucket impact vector (DeepImpact-style),
initialized from corpus idf by `idf_lexical_prior` before training: a
uniform prior scores "was born in" matches as high as entity matches,
so on held-out questions distractor sentences sharing only stop-words
crowd out gold ones (measured: uniform prior held-out recall@10 0.23 at
the 60-step point vs BM25's 0.5; idf init closes the gap — see
cli/train_splade.py). Unseen buckets get the maximum idf, which is what
makes NOVEL entity tokens rank at held-out time.

With subword featurization the prior lands ONLY on each position's
whole-word bucket (slot 0 of `_word_feature_ids`): char n-gram buckets
collide across words, and scattering the prior onto them makes sparse
exact-match scoring fuzzy — measured at init, prior-on-all-slots gets
held-out recall@10 0.09 while prior-on-word-bucket gets ~BM25 parity.
The char n-gram buckets stay available to the LEARNED expansion (the
tied decoder can emit them), so fuzzy subword matching is something
training can opt into where it pays, instead of a structural floor of
noise.

The b0 self-token boost (uniCOIL / DeepImpact lineage: score the terms
that are PRESENT, learn expansion on top) is what makes from-scratch
training converge. Published SPLADE fine-tunes a pretrained MLM head
whose logits already rank each position's own token highly; with a
randomly initialized trunk the max-pooled expansions are dominated by
position-embedding structure shared across texts, every in-batch score
ties, InfoNCE sits at ln(B) with near-zero signal, and 300 steps of
AdamW never escape (measured: in-batch accuracy pinned at 1/64,
held-out recall@10 0.008 vs BM25's 0.5). Scattering a learnable b0
(init 2.0) onto each position's own hash buckets makes the initial
expansion exactly the text's own tokens — the InfoNCE gradient then
carries lexical-overlap signal from step 0, and the tied decoder learns
which co-occurring buckets to expand into on top of it.

Design notes:
  - the [B, L, V] logits tensor never materializes: a `lax.scan` over the
    L token positions runs one [B, D] @ [D, V] matmul per step and
    folds the max into a [B, V] carry (64 steps of a 2048x128x8192 matmul
    beat one 4.3 GB intermediate at B=2048);
  - training is in-batch InfoNCE over sparse dot products plus the FLOPS
    regularizer (sum_t mean_batch(w_t)^2) that drives expansion sparsity;
  - vocabulary = the encoder's hashed vocab (crc32 buckets), so no
    external vocab file exists anywhere in the stack.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .encoder import (
    EncoderConfig,
    _layer_norm,
    encode_hidden,
    encode_tokens,
    init_params,
)


@dataclass(frozen=True)
class SpladeConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    # budgets are in hash BUCKETS, not words: with subword_ngrams=8 each
    # word expands to ~8 buckets, so 32 query terms ~ 4 words. The round-3
    # defaults (16/64) silently kept ~2 query words under the flagship
    # subword config and held-out retrieval collapsed to chance while
    # in-batch (dense-dot) accuracy looked healthy
    doc_top_terms: int = 128    # expansion terms kept per document
    query_top_terms: int = 32   # expansion terms kept per query
    flops_lambda: float = 3e-4  # FLOPS regularizer weight (doc side)
    flops_lambda_q: float = 1e-4  # FLOPS regularizer weight (query side)

    @property
    def vocab_size(self) -> int:
        return self.encoder.vocab_size


# ---------------- params ----------------


def init_splade_params(rng: jax.Array, cfg: SpladeConfig) -> Dict[str, Any]:
    """Encoder trunk params + the expansion head (transform + tied decoder
    bias). The decoder weight IS ``tok_emb`` (tied, SPLADE/MLM-style)."""
    k_trunk, k_head = jax.random.split(rng)
    params = init_params(k_trunk, cfg.encoder)
    d = cfg.encoder.d_model
    params["splade_head"] = {
        "wt": jax.random.normal(k_head, (d, d)) * (d ** -0.5),
        "ln": {"g": jnp.ones((d,)), "b": jnp.zeros((d,))},
        "bias": jnp.zeros((cfg.vocab_size,)),
        # lexical-prior boost added to each position's own token buckets
        # (see module docstring: this is what makes from-scratch training
        # leave the tied-score basin)
        "b0": jnp.asarray(2.0, dtype=jnp.float32),
        # expansion gate: scales the tied-decoder logits. Starts small so
        # the initial expansion is ~purely lexical — with a unit-scale
        # gate the max over L positions of the random decoder logits
        # (~2.5 sigma) outweighs b0 and the expansions are noise
        # (measured: 1/16 top query terms were own-token buckets and an
        # unrelated document outscored the gold one at init)
        "g_exp": jnp.asarray(0.1, dtype=jnp.float32),
        # per-bucket lexical impact (DeepImpact lineage), multiplied into
        # the b0 self-token boost. Ones = uniform; training CLIs replace
        # it with corpus idf via `idf_lexical_prior` before the first
        # step (module docstring)
        "lex_w": jnp.ones((cfg.vocab_size,), dtype=jnp.float32),
    }
    return params


def idf_lexical_prior(texts: List[str], cfg: SpladeConfig,
                      batch: int = 1024) -> np.ndarray:
    """Per-bucket idf over ``texts``' WHOLE-WORD buckets (the only slots
    the lexical prior scatters onto — module docstring), normalized to
    mean 1 over the observed buckets so b0 stays the scale knob. Unseen
    buckets get the maximum idf — novel entity tokens at held-out time
    score like the rarest training terms, not like noise.

    -> float32 [vocab_size], drop-in value for params["splade_head"]["lex_w"].
    """
    V = cfg.vocab_size
    df = np.zeros((V,), dtype=np.int64)
    n = 0
    for start in range(0, len(texts), batch):
        ids, mask = encode_tokens(list(texts[start:start + batch]),
                                  cfg.encoder)
        ids = np.asarray(ids)
        if ids.ndim == 3:
            ids = ids[:, :, 0]
        mask = np.asarray(mask)
        for row in range(ids.shape[0]):
            df[np.unique(ids[row][mask[row] > 0])] += 1
            n += 1
    idf = np.log1p(n / (1.0 + df)).astype(np.float32)
    seen = df > 0
    if seen.any():
        idf /= float(idf[seen].mean())
    return idf


# ---------------- forward ----------------


def splade_from_hidden(params: Dict[str, Any], h: jax.Array,
                       mask: jax.Array, cfg: SpladeConfig,
                       token_ids: jax.Array) -> jax.Array:
    """Expansion head over precomputed trunk hidden states [B, L, D] —
    lets a hybrid program run the trunk ONCE and feed both the dense
    pooling head and this head. -> [B, V] f32 term weights.

    ``token_ids`` ([B, L] or [B, L, G]) carries each position's own hash
    buckets for the b0 lexical-prior scatter (module docstring).

    SPLADE-max over token positions; the per-position vocab logits are
    produced one position at a time under `lax.scan` so no [B, L, V]
    buffer exists (see module docstring).
    """
    ecfg = cfg.encoder
    head = params["splade_head"]
    t = jnp.dot(h.astype(ecfg.dtype), head["wt"].astype(ecfg.dtype),
                preferred_element_type=jnp.float32)
    t = _layer_norm(jax.nn.gelu(t), head["ln"]["g"], head["ln"]["b"])

    emb_t = params["tok_emb"].T  # [D, V] (tied decoder)
    bias = head["bias"]
    b0 = head["b0"]
    g_exp = head["g_exp"]
    lex_w = head["lex_w"]
    B = h.shape[0]
    # prior target = the whole-word bucket only (slot 0 in subword mode;
    # see module docstring — char n-gram buckets collide across words
    # and must not carry the exact-match prior)
    word_ids = token_ids if token_ids.ndim == 2 else token_ids[:, :, 0]
    rows = jnp.arange(B)
    ids_x = word_ids.T

    def step(carry, inputs):
        t_l, m_l, ids_l = inputs  # [B, D], [B], [B]
        logits = g_exp * jnp.dot(
            t_l.astype(ecfg.dtype), emb_t.astype(ecfg.dtype),
            preferred_element_type=jnp.float32) + bias
        logits = logits.at[rows, ids_l].add(b0 * lex_w[ids_l])
        w = jnp.log1p(jax.nn.relu(logits)) * m_l[:, None]
        return jnp.maximum(carry, w), None

    init = jnp.zeros((B, cfg.vocab_size), dtype=jnp.float32)
    w, _ = jax.lax.scan(step, init,
                        (t.transpose(1, 0, 2), mask.T, ids_x))
    return w


def apply_splade(params: Dict[str, Any], token_ids: jax.Array,
                 mask: jax.Array, cfg: SpladeConfig) -> jax.Array:
    """token ids [B, L] (or [B, L, G]) -> sparse term weights [B, V] f32."""
    h = encode_hidden(params, token_ids, mask, cfg.encoder)
    return splade_from_hidden(params, h, mask, cfg, token_ids)


def sparsify_topk(w: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """[B, V] dense expansion -> (term ids [B, k] int32 with -1 padding,
    weights [B, k] f32). Zero-weight slots pad to -1 so the posting
    machinery's valid-mask drops them."""
    vals, ids = jax.lax.top_k(w, k)
    ids = jnp.where(vals > 0, ids, -1).astype(jnp.int32)
    vals = jnp.where(vals > 0, vals, 0.0)
    return ids, vals


# ---------------- training ----------------


def _topk_dense(w: jax.Array, k: int) -> jax.Array:
    """Zero every entry of [B, V] outside each row's top-k (the serving
    sparsification, kept dense for the in-batch score matmul). Gradients
    flow through the surviving entries only — training optimizes exactly
    the truncated representation the CSR index will hold."""
    vals, ids = jax.lax.top_k(w, k)
    rows = jnp.arange(w.shape[0])[:, None]
    return jnp.zeros_like(w).at[rows, ids].set(jnp.maximum(vals, 0.0))


def splade_loss(params, batch, cfg: SpladeConfig, temperature: float = 1.0):
    """In-batch InfoNCE over SPARSIFIED dot products + FLOPS regularizers.

    Raw dot products (temperature 1.0, the SPLADE convention): sparse
    expansion dots are already O(10-100), unlike L2-normalized cosine.

    The InfoNCE scores use the same top-k truncation as serving
    (query_top_terms / doc_top_terms): a dense-dot objective can reach
    high in-batch accuracy through weight spread far outside the kept
    budget, and the indexed model then retrieves at chance (measured:
    acc 0.52 / held-out recall@10 0.008 before this alignment).

    batch: q_ids/q_mask/p_ids/p_mask as produced by
    `TextEncoder.make_pair_batch` (same host featurizer)."""
    wq = apply_splade(params, batch["q_ids"], batch["q_mask"], cfg)
    wp = apply_splade(params, batch["p_ids"], batch["p_mask"], cfg)
    wq_s = _topk_dense(wq, min(cfg.query_top_terms, cfg.vocab_size))
    wp_s = _topk_dense(wp, min(cfg.doc_top_terms, cfg.vocab_size))
    logits = jnp.dot(wq_s, wp_s.T, preferred_element_type=jnp.float32)
    logits = logits / temperature
    labels = jnp.arange(wq.shape[0])
    nce = jnp.mean(-jax.nn.log_softmax(logits, axis=-1)[labels, labels])
    # FLOPS regularizer (Paria et al. / SPLADE): sum_t (mean_batch w_t)^2
    flops_p = jnp.sum(jnp.mean(wp, axis=0) ** 2)
    flops_q = jnp.sum(jnp.mean(wq, axis=0) ** 2)
    loss = nce + cfg.flops_lambda * flops_p + cfg.flops_lambda_q * flops_q
    acc = jnp.mean((jnp.argmax(logits, axis=-1) == labels).astype(jnp.float32))
    nnz = jnp.mean(jnp.sum((wp > 0).astype(jnp.float32), axis=-1))
    return loss, {"accuracy": acc, "nce": nce, "doc_nnz": nnz}


def make_splade_train_step(cfg: SpladeConfig, learning_rate: float = 1e-3):
    import optax

    tx = optax.adamw(learning_rate)

    def init_state(params):
        return tx.init(params)

    def train_step(params, opt_state, batch):
        (loss, aux), grads = jax.value_and_grad(
            lambda p: splade_loss(p, batch, cfg), has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **aux}

    return init_state, train_step


# ---------------- inference wrapper ----------------


class SpladeEncoder:
    """Host tokenize + device expand. `expand_texts` returns the sparse
    (ids, weights) pairs that feed the CSR posting scorer."""

    def __init__(self, cfg: Optional[SpladeConfig] = None, params=None,
                 seed: int = 0):
        self.cfg = cfg or SpladeConfig()
        if params is None:
            params = init_splade_params(jax.random.PRNGKey(seed), self.cfg)
        self.params = params
        self._apply = jax.jit(functools.partial(apply_splade, cfg=self.cfg))
        self._expand = {}  # k -> jitted expand

    def host_featurize(self, texts: List[str]):
        return encode_tokens(list(texts), self.cfg.encoder)

    def _expand_fn(self, k: int):
        fn = self._expand.get(k)
        if fn is None:
            def expand(params, ids, mask):
                return sparsify_topk(
                    apply_splade(params, ids, mask, self.cfg), k)
            fn = self._expand[k] = jax.jit(expand)
        return fn

    def expand_texts(self, texts: List[str], k: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (term ids [B, k] int32, weights [B, k] f32), -1-padded."""
        k = k or self.cfg.query_top_terms
        if not texts:
            return (np.zeros((0, k), np.int32), np.zeros((0, k), np.float32))
        ids, mask = self.host_featurize(texts)
        t_ids, t_w = self._expand_fn(k)(
            self.params, jnp.asarray(ids), jnp.asarray(mask))
        return np.asarray(t_ids), np.asarray(t_w)

    def dense_expand(self, texts: List[str]) -> np.ndarray:
        """[B, V] dense expansion weights (tests / training eval)."""
        ids, mask = self.host_featurize(texts)
        return np.asarray(self._apply(self.params, jnp.asarray(ids),
                                      jnp.asarray(mask)))

    def save(self, path: str) -> None:
        import dataclasses
        import json as _json

        flat, _ = jax.tree_util.tree_flatten_with_path(self.params)
        # the checkpoint must carry its own architecture: training CLIs
        # use non-default shapes (d_model 64, subword_ngrams 8) and a
        # bare `SpladeEncoder.load(path)` with the default config would
        # reject every weight on shape mismatch
        cfg_doc = dataclasses.asdict(self.cfg)
        cfg_doc["encoder"]["dtype"] = np.dtype(
            self.cfg.encoder.dtype).name
        np.savez(path, __config__=np.frombuffer(
            _json.dumps(cfg_doc).encode("utf-8"), dtype=np.uint8),
            **{jax.tree_util.keystr(k): np.asarray(v) for k, v in flat})

    @classmethod
    def load(cls, path: str, cfg: Optional[SpladeConfig] = None
             ) -> "SpladeEncoder":
        import json as _json

        data = np.load(path)
        if cfg is None and "__config__" in data:
            doc = _json.loads(bytes(data["__config__"]).decode("utf-8"))
            enc_doc = dict(doc.pop("encoder"))
            enc_doc["dtype"] = {"bfloat16": jnp.bfloat16,
                                "float16": jnp.float16,
                                "float32": jnp.float32}[
                enc_doc.get("dtype", "bfloat16")]
            cfg = SpladeConfig(encoder=EncoderConfig(**enc_doc), **doc)
        cfg = cfg or SpladeConfig()
        template = init_splade_params(jax.random.PRNGKey(0), cfg)
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
                    f"{np.asarray(v).shape} — check SpladeConfig matches "
                    "the checkpoint")
            leaves.append(jnp.asarray(arr))
        return cls(cfg, params=jax.tree_util.tree_unflatten(treedef, leaves))
