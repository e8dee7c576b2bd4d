"""Caption-similarity retrieval pool for batch TTA (counterpart of
``longcat_video_tta_tpu/data/retrieval.py``): cosine k-NN over caption
embeddings, the query video excluded by absolute path. The embedder is a
SentenceTransformer model from a local folder when one is given (which
needs the ``sentence_transformers`` package: without it that raises),
else a deterministic hashed bag-of-words embedding."""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional

import numpy as np


def hashed_bow_embed(texts: List[str], dim: int = 512) -> np.ndarray:
    """Deterministic hashed bag-of-words embedding, L2-normalized."""
    out = np.zeros((len(texts), dim), np.float32)
    for i, t in enumerate(texts):
        for w in t.lower().split():
            h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
            out[i, h % dim] += 1.0
            out[i, (h // dim) % dim] += 0.5
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-8)


def sbert_embed_fn(model_path: str):
    """A SentenceTransformer embedder of the model at ``model_path``;
    raises ImportError where ``sentence_transformers`` is not installed."""
    try:
        from sentence_transformers import SentenceTransformer
    except ImportError as e:
        raise ImportError(f"--retrieval-sbert-path {model_path} needs the "
                          f"sentence_transformers package ({e})") from e

    model = SentenceTransformer(model_path, device="cpu")

    def embed(texts: List[str]) -> np.ndarray:
        return np.asarray(model.encode(texts, normalize_embeddings=True), np.float32)

    return embed


class RetrievalPool:
    """Caption-embedding pool with cosine k-NN."""

    def __init__(self, entries: List[Dict], embed_fn=None):
        self.entries = entries
        self.embedder = "sbert" if embed_fn is not None else "hashed_bow"
        self.embed = embed_fn or hashed_bow_embed
        self.vectors = self.embed([e["caption"] for e in entries])
        self._by_path = {os.path.abspath(e["path"]): i for i, e in enumerate(entries)}

    def neighbors(self, caption: str, query_path: str, k: int) -> List[Dict]:
        """The ``k`` nearest entries by caption cosine, the query video
        excluded by absolute path."""
        q = self.embed([caption])[0]
        sims = self.vectors @ q
        qi = self._by_path.get(os.path.abspath(query_path), -1)
        if qi >= 0:
            sims[qi] = -np.inf
        order = np.argsort(-sims)
        return [self.entries[i] for i in order[:k]]


def build_retrieval_pool(pool_entries: List[Dict],
                         sbert_model_path: Optional[str] = None) -> RetrievalPool:
    embed_fn = None
    if sbert_model_path:
        if not os.path.exists(sbert_model_path):
            raise FileNotFoundError(f"--retrieval-sbert-path {sbert_model_path} "
                                    "does not exist")
        embed_fn = sbert_embed_fn(sbert_model_path)
    return RetrievalPool(pool_entries, embed_fn)
