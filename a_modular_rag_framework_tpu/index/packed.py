"""PackedIndex — the on-disk / on-device index artifact.

This is the checkpoint of the retrieval subsystem (SURVEY.md §5): embedding
shards + BM25 CSR + sentence-graph adjacency + manifest with checksums, all
as flat numpy arrays that deserialize straight to device memory. It replaces
the reference's trio of docs.jsonl re-index (text_index.py:32-53), per-query
graph.json reload (graph_utils.py:13-22) and remote embeddings.

Directory layout (``<root>/``):

  manifest.json      shapes, dtypes, sha256 checksums, build stats
  embeddings.npy     [N, d] f32 or bf16-as-uint16 corpus embeddings
  bm25_doc_ids.npy   [P] int32   flat CSR postings (doc row per posting)
  bm25_tfs.npy       [P] f32     term frequencies
  bm25_row_ptr.npy   [V+1] int32 postings offsets per term id
  bm25_df.npy        [V] f32     document frequency per term
  bm25_doc_lens.npy  [N] f32     tokens per sentence
  vocab.json         term -> term id
  graph_next.npy     [N, 2] int32 next-in-doc adjacency (-1 padded)
  graph_entity.npy   [N, deg] int32 shared-entity adjacency (-1 padded)
  docs.jsonl         row metadata (schema of reference ingest output)
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from ..ops.bm25 import Bm25DeviceIndex
from .corpus import SentenceCorpus, write_docs_jsonl


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _save_embeddings(path: Path, emb: np.ndarray, dtype: str) -> None:
    if dtype == "bfloat16":
        if emb.dtype == np.uint16:  # already bf16 bit patterns (round-trip)
            np.save(path, emb)
            return
        # store the top 16 bits of the f32 pattern (round-to-nearest-even)
        u = np.ascontiguousarray(emb, dtype=np.float32).view(np.uint32)
        rounded = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
        np.save(path, rounded.astype(np.uint16))
    else:
        np.save(path, emb.astype(np.float32))


def _load_embeddings(path: Path, dtype: str, mmap: bool) -> np.ndarray:
    arr = np.load(path, mmap_mode="r" if mmap else None)
    if dtype == "bfloat16":
        return arr  # uint16 bit pattern; expanded on device via view
    return arr


@dataclass(eq=False)  # identity eq/hash: every cache in the system keys
class PackedIndex:     # on "is this the same index OBJECT" (engine jit
    # cache invalidation, the native bridge WeakKeyDictionary); field-wise
    # equality over multi-GB arrays is never wanted and made the class
    # unhashable.
    """Loaded packed index. Arrays are host numpy (possibly memory-mapped);
    `device_arrays` produces the device-resident views used by the engine."""

    corpus: SentenceCorpus
    embeddings: np.ndarray  # [N, d] f32, or uint16 bf16 bit patterns
    embed_dtype: str
    bm25: Bm25DeviceIndex
    graph_next: np.ndarray  # [N, 2] int32 next-in-doc adjacency
    graph_entity: np.ndarray  # [N, deg] int32 shared-entity adjacency
    manifest: Dict[str, Any] = field(default_factory=dict)

    @property
    def n_docs(self) -> int:
        return len(self.corpus)

    @property
    def embed_dim(self) -> int:
        return int(self.embeddings.shape[1]) if self.embeddings.size else 0

    # ---- persistence ----

    def save(self, root: str | Path) -> Dict[str, Any]:
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)

        write_docs_jsonl(self.corpus.docs, root / "docs.jsonl")
        _save_embeddings(root / "embeddings.npy", self.embeddings, self.embed_dtype)
        np.save(root / "bm25_doc_ids.npy", self.bm25.doc_ids)
        np.save(root / "bm25_tfs.npy", self.bm25.tfs)
        np.save(root / "bm25_row_ptr.npy", self.bm25.row_ptr)
        np.save(root / "bm25_df.npy", self.bm25.df)
        np.save(root / "bm25_doc_lens.npy", self.bm25.doc_lens)
        (root / "vocab.json").write_text(json.dumps(self.bm25.vocab), encoding="utf-8")
        np.save(root / "graph_next.npy", self.graph_next)
        np.save(root / "graph_entity.npy", self.graph_entity)

        files = [
            "docs.jsonl", "embeddings.npy", "bm25_doc_ids.npy", "bm25_tfs.npy",
            "bm25_row_ptr.npy", "bm25_df.npy", "bm25_doc_lens.npy",
            "vocab.json", "graph_next.npy", "graph_entity.npy",
        ]
        manifest = {
            "format_version": 1,
            "n_docs": self.n_docs,
            "embed_dim": self.embed_dim,
            "embed_dtype": self.embed_dtype,
            "bm25": {"k1": self.bm25.k1, "b": self.bm25.b,
                     "vocab_size": len(self.bm25.vocab),
                     "n_postings": int(self.bm25.doc_ids.shape[0])},
            "graph_max_degree": int(self.graph_entity.shape[1]) if self.graph_entity.size else 0,
            "checksums": {f: _sha256(root / f) for f in files},
            **{k: v for k, v in self.manifest.items() if k not in {"checksums"}},
        }
        (root / "manifest.json").write_text(json.dumps(manifest, indent=2), encoding="utf-8")
        self.manifest = manifest
        return manifest

    @classmethod
    def load(cls, root: str | Path, *, mmap: bool = True, verify_checksums: bool = False) -> "PackedIndex":
        root = Path(root)
        manifest = json.loads((root / "manifest.json").read_text(encoding="utf-8"))
        if verify_checksums:
            for f, want in manifest.get("checksums", {}).items():
                got = _sha256(root / f)
                if got != want:
                    raise ValueError(f"checksum mismatch for {f}: {got} != {want}")

        corpus = SentenceCorpus.from_jsonl(root / "docs.jsonl")
        embed_dtype = manifest.get("embed_dtype", "float32")
        embeddings = _load_embeddings(root / "embeddings.npy", embed_dtype, mmap)
        vocab = json.loads((root / "vocab.json").read_text(encoding="utf-8"))
        bm25 = Bm25DeviceIndex(
            doc_ids=np.load(root / "bm25_doc_ids.npy", mmap_mode="r" if mmap else None),
            tfs=np.load(root / "bm25_tfs.npy", mmap_mode="r" if mmap else None),
            row_ptr=np.load(root / "bm25_row_ptr.npy"),
            df=np.load(root / "bm25_df.npy"),
            doc_lens=np.load(root / "bm25_doc_lens.npy"),
            vocab=vocab,
            k1=float(manifest.get("bm25", {}).get("k1", 1.5)),
            b=float(manifest.get("bm25", {}).get("b", 0.75)),
        )
        graph_next = np.load(root / "graph_next.npy", mmap_mode="r" if mmap else None)
        graph_entity = np.load(root / "graph_entity.npy", mmap_mode="r" if mmap else None)
        return cls(corpus=corpus, embeddings=embeddings, embed_dtype=embed_dtype,
                   bm25=bm25, graph_next=graph_next, graph_entity=graph_entity,
                   manifest=manifest)

    # ---- device residency ----

    def device_embeddings(self):
        """Corpus embedding matrix as a device array (bf16 stored indexes
        expand from their uint16 bit patterns without an f32 round-trip)."""
        import jax.numpy as jnp

        arr = np.ascontiguousarray(self.embeddings)
        if self.embed_dtype == "bfloat16":
            if arr.dtype == np.uint16:  # loaded bit patterns
                return jnp.asarray(arr).view(jnp.bfloat16)
            return jnp.asarray(arr.astype(np.float32)).astype(jnp.bfloat16)
        return jnp.asarray(arr)

    def device_bm25(self) -> Dict[str, Any]:
        return self.bm25.device_arrays()

    def device_graph(self, *, include_entity: bool = True):
        """Neighbor table for frontier expansion: next-in-doc chains, plus
        entity links when ``include_entity`` (the enhanced 2-hop mode)."""
        import jax.numpy as jnp

        nxt = np.ascontiguousarray(self.graph_next)
        if include_entity and self.graph_entity.size:
            ent = np.ascontiguousarray(self.graph_entity)
            return jnp.asarray(np.concatenate([nxt, ent], axis=1))
        return jnp.asarray(nxt)
