"""Local embedding provider — the router's on-device embedding path.

The reference fetched embeddings from a remote API in batches of 50
(retrieval_backend.py:233-243). Here embeddings are produced by a jitted
batched encoder running on the local accelerator: texts are tokenized on the
host, padded to a bucketed [B, L] int32 batch, and encoded in one device
program. The same encoder powers index build (`index.builder`) and query-time
embedding (`engine.query_engine`), so query/corpus vectors always agree.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class LocalEmbedProvider:
    """Batched on-device text encoder behind the `LLMProvider` protocol.

    Parameters
    ----------
    encoder : optional object with ``encode_texts(List[str]) -> np.ndarray``;
        defaults to the deterministic hash encoder (`models.hash_embed`),
        which needs no weights. Swap in `models.encoder.TextEncoder` for a
        learned transformer encoder.
    """

    def __init__(
        self,
        encoder: Optional[Any] = None,
        embed_dim: int = 64,
        max_batch: int = 1024,
        **_: Any,
    ):
        self.embed_dim = int(embed_dim)
        self.max_batch = int(max_batch)
        if encoder is None:
            from ...models.hash_embed import HashEmbedEncoder

            encoder = HashEmbedEncoder(dim=self.embed_dim)
        self.encoder = encoder

    def complete(self, prompt: str, **kw: Any) -> Dict[str, Any]:
        raise NotImplementedError("LocalEmbedProvider is embeddings-only")

    def embed(self, texts: List[str], **kw: Any) -> Dict[str, Any]:
        texts = list(texts)
        chunks: List[np.ndarray] = []
        for i in range(0, len(texts), self.max_batch):
            vecs = self.encoder.encode_texts(texts[i : i + self.max_batch])
            chunks.append(np.asarray(vecs))
        if chunks:
            out = np.concatenate(chunks, axis=0)
        else:
            out = np.zeros((0, self.embed_dim), dtype=np.float32)
        return {"vectors": [v.tolist() for v in out]}
