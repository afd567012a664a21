"""Deterministic hash-feature text encoder (the weight-free mock encoder).

The reference used a 1-dim ``hash(text) % 1000`` fake embedding as its test
fallback (edge_builder.py:47-48), which carries no lexical signal. This
encoder is the device-side replacement: stable feature hashing of unigrams and
bigrams into a ``dim``-bucket signed space, L2-normalized — so cosine
similarity is a real lexical-overlap signal and the whole retrieval stack can
be built, tested, and benchmarked without trained weights. The learned
transformer encoder (`models.encoder.TextEncoder`) is a drop-in replacement
behind the same ``encode_texts`` / ``encode_token_batch`` interface.

Two paths share one construction:
  - `hash_embed_numpy`: pure-host path (used by MockProvider);
  - `HashEmbedEncoder`: tokenize/hash on host, scatter-accumulate + normalize
    as one jitted device program over padded [B, L] batches.
"""
from __future__ import annotations

import re
import zlib
from functools import partial
from typing import List, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[^a-zA-Z0-9]+")


def tokenize(text: str) -> List[str]:
    """Same tokenizer as the BM25 index (reference text_index.py:10-11)."""
    return [t for t in _TOKEN_RE.split((text or "").lower()) if t]


def phrase_augment(text: str) -> str:
    """Append joined capitalized-run phrase tokens to ``text``.

    "Ananan Belanan was born..." gains the pseudo-word "ananan00belanan"
    ("00" joiner survives the alnum tokenizer as one token). On a
    colliding-name corpus the individual name tokens are shared by
    hundreds of people, but the full-name phrase token is near-unique, so
    BM25's idf concentrates exactly on the entity the query names —
    classic phrase indexing, done at the text level so the Python and
    native C++ tokenizers both see it. Queries are always augmented
    (engine.encode_query_term_ids); unknown phrase tokens simply miss the
    vocab, so indexes built without augmentation are unaffected.
    """
    # str.islower() is a C-speed scan: pruned/re-joined queries are fully
    # lowercase, so the (second) augmentation pass on them skips the
    # capitalized-run walk
    if not text or text.islower():
        return text
    from ..utils.textspan import capitalized_runs

    runs = [r for r in capitalized_runs(text) if " " in r]
    if not runs:
        return text
    extra = ["00".join(tokenize(r)) for r in runs]
    return f"{text} {' '.join(extra)}"


def _features(text: str) -> List[str]:
    toks = tokenize(text)
    feats = list(toks)
    feats.extend(f"{a}_{b}" for a, b in zip(toks, toks[1:]))
    return feats


def _bucket_sign(feat: str, dim: int) -> Tuple[int, float]:
    h = zlib.crc32(feat.encode("utf-8"))
    bucket = h % dim
    sign = 1.0 if (h >> 16) & 1 else -1.0
    return bucket, sign


def hash_embed_numpy(texts: List[str], dim: int = 64) -> np.ndarray:
    """Host reference path: [N, dim] float32, L2-normalized rows."""
    out = np.zeros((len(texts), dim), dtype=np.float32)
    for i, t in enumerate(texts):
        for feat in _features(t):
            b, s = _bucket_sign(feat, dim)
            out[i, b] += s
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-9)


class HashEmbedEncoder:
    """Device-batched hash encoder.

    Host side hashes features into ``(bucket, sign)`` pairs padded to a fixed
    feature length; the device program scatter-accumulates and L2-normalizes
    the batch in one fused XLA computation.
    """

    def __init__(self, dim: int = 64, max_features: int = 256):
        self.dim = int(dim)
        self.max_features = int(max_features)

    # ---- host preprocessing ----

    def featurize(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Return padded (buckets int32 [B, L], signs float32 [B, L]).

        Padding rows point at bucket 0 with sign 0 (no-op contribution).
        Uses the native C++ featurizer when available (bit-exact; ~50x the
        python loop), falling back to pure Python.
        """
        try:
            from ..native import featurize_batch_native

            native = featurize_batch_native(texts, self.dim, self.max_features)
            if native is not None:
                return native
        except ImportError:
            pass
        B, L = len(texts), self.max_features
        buckets = np.zeros((B, L), dtype=np.int32)
        signs = np.zeros((B, L), dtype=np.float32)
        for i, t in enumerate(texts):
            feats = _features(t)[:L]
            for j, feat in enumerate(feats):
                b, s = _bucket_sign(feat, self.dim)
                buckets[i, j] = b
                signs[i, j] = s
        return buckets, signs

    # ---- device program ----

    @staticmethod
    @partial(__import__("jax").jit, static_argnums=(2,))
    def _encode(buckets, signs, dim: int):
        import jax
        import jax.numpy as jnp

        # one-hot einsum instead of scatter-add: a dense contraction with
        # no atomics; dim is small, so the [B, L, dim] one-hot is cheap.
        # HIGHEST keeps the f32 sum exact (no TF32 rounding on a GPU).
        oh = jax.nn.one_hot(buckets, dim, dtype=jnp.float32)
        acc = jnp.einsum("bld,bl->bd", oh, signs,
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
        norms = jnp.sqrt(jnp.sum(acc * acc, axis=1, keepdims=True))
        return acc / jnp.maximum(norms, 1e-9)

    def encode_token_batch(self, buckets: np.ndarray, signs: np.ndarray) -> np.ndarray:
        """Vectorized HOST accumulation (per-row bincount + normalize).

        For standalone batch encoding the host path beats the device one:
        the computation is trivial (scatter of ~100 signs per row into a
        64-dim vector) while a device dispatch costs a compile the first
        time plus two transfers every time. The device path
        (`device_embed`) exists for fusion INSIDE the engine's query
        program, where it's free."""
        B = buckets.shape[0]
        acc = np.empty((B, self.dim), dtype=np.float32)
        for i in range(B):
            acc[i] = np.bincount(buckets[i], weights=signs[i],
                                 minlength=self.dim)[: self.dim]
        norms = np.linalg.norm(acc, axis=1, keepdims=True)
        return acc / np.maximum(norms, 1e-9)

    # ---- in-program embedding (engine fuses this into its device program
    # so query encoding doesn't cost a second dispatch) ----

    def host_featurize(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        return self.featurize(texts)

    def device_embed(self, buckets, signs):
        """Traceable embedding for use inside a larger jitted program."""
        import jax
        import jax.numpy as jnp

        oh = jax.nn.one_hot(buckets, self.dim, dtype=jnp.float32)
        acc = jnp.einsum("bld,bl->bd", oh, signs,
                         precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
        norms = jnp.sqrt(jnp.sum(acc * acc, axis=1, keepdims=True))
        return acc / jnp.maximum(norms, 1e-9)

    def encode_texts(self, texts: List[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        try:
            from ..native import hash_embed_batch_native

            # fused featurize+accumulate+normalize in one C call: no
            # [B, max_features] intermediates, no per-row bincount loop
            out = hash_embed_batch_native(texts, self.dim, self.max_features)
            if out is not None:
                return out
        except ImportError:
            pass
        buckets, signs = self.featurize(texts)
        return self.encode_token_batch(buckets, signs)
