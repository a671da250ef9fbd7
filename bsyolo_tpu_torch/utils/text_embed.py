"""Deterministic offline text embeddings for the open-vocab (World) path (a copy of
``bsyolo_tpu/utils/text_embed.py``, numpy only, so the port imports nothing of the JAX package), and
``world_text``, the one resolver of a YOLO-World graph's text that the trainer and ``set_classes`` share.

The reference computes class-text embeddings with CLIP ViT-B/32
(reference models/yolo/world/train.py); CLIP is not bundled with the
project. This module provides a clearly-labeled NON-CLIP stand-in:
hashed character n-gram vectors. They are deterministic, dependency-free,
and lexically smooth (similar strings -> similar vectors), which is enough
to drive the full C2fAttn/ImagePoolingAttn/contrastive-head machinery end
to end — but they carry no visual-semantic alignment, so detection quality
with an untrained/converted model is NOT meaningful. For real open-vocab
quality, pass CLIP embeddings via ``set_classes(..., embeddings=...)``.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np


def hashed_text_embeddings(names: Sequence[str], dim: int = 512, seed: int = 0) -> np.ndarray:
    """(K,) class-name strings -> (K, dim) L2-normalized float32 vectors.

    Feature-hashed character n-grams (n = 2, 3, 4) over the lowercased,
    boundary-marked name; each n-gram contributes +/-1 at a blake2b-derived
    index. Same name (and seed) always yields the same vector.
    """
    out = np.zeros((len(names), dim), np.float32)
    key = str(seed).encode()
    for i, name in enumerate(names):
        t = f"<{str(name).lower().strip()}>"
        for n in (2, 3, 4):
            for j in range(max(len(t) - n + 1, 0)):
                h = int.from_bytes(
                    hashlib.blake2b(t[j : j + n].encode(), digest_size=8, key=key).digest(),
                    "little",
                )
                sign = 1.0 if (h >> 63) & 1 else -1.0
                out[i, h % dim] += sign
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(norm, 1e-12)


def load_text_embeddings(source) -> dict:
    """Load a saved name->vector embedding table.

    Accepts a dict (returned as-is, values coerced to float32), or a path to
    an ``.npz``/``.npy`` file in either layout:

    - ``np.savez(path, **{name: vector})`` — one array per class name;
    - ``np.savez(path, names=<(K,) str array>, vectors=<(K, dim) array>)`` —
      the bulk layout CLIP-export scripts produce.

    This is the offline half of the reference's text pipeline (reference
    models/yolo/world/train.py encodes names with CLIP per run): compute CLIP
    ViT-B/32 embeddings once on any machine with CLIP, save the npz, and this
    framework consumes them for training and set_classes.
    """
    if isinstance(source, dict):
        return {str(k): np.asarray(v, np.float32).reshape(-1) for k, v in source.items()}
    data = np.load(str(source), allow_pickle=False)
    if hasattr(data, "files"):
        if "names" in data.files and "vectors" in data.files:
            names = [str(n) for n in data["names"].tolist()]
            vecs = np.asarray(data["vectors"], np.float32)
            if vecs.ndim != 2 or len(names) != vecs.shape[0]:
                raise ValueError(
                    f"names/vectors layout mismatch: {len(names)} names, vectors {vecs.shape}"
                )
            return dict(zip(names, vecs))
        return {k: np.asarray(data[k], np.float32).reshape(-1) for k in data.files}
    raise ValueError(f"expected .npz with named arrays, got {type(data)} from {source}")


def resolve_text_embeddings(names: Sequence[str], source) -> np.ndarray:
    """(K,) class names + saved table -> (K, dim) matrix.

    ``source``: dict / .npz path (load_text_embeddings) or an array (passed
    through). "/"-joined synonym names average the per-synonym vectors
    (reference YOLOMultiModalDataset update_labels_info, data/dataset.py:270).
    Missing names raise with the full missing list.
    """
    if isinstance(source, np.ndarray) or (
        not isinstance(source, (str, dict)) and hasattr(source, "shape")
    ):
        return np.asarray(source, np.float32)
    table = load_text_embeddings(source)
    rows, missing = [], []
    for name in names:
        syns = [s.strip() for s in str(name).split("/") if s.strip()]
        vecs = []
        if str(name) in table:  # exact (possibly "/"-joined) key wins
            vecs = [table[str(name)]]
        else:
            vecs = [table[s] for s in syns if s in table]
        if not vecs:
            missing.append(str(name))
            rows.append(np.zeros(next(iter(table.values())).shape, np.float32))
        else:
            rows.append(np.mean(vecs, axis=0))
    if missing:
        raise KeyError(
            f"text embedding table has no vectors for classes {missing}; "
            f"table keys: {sorted(table)[:20]}{'...' if len(table) > 20 else ''}"
        )
    return np.stack(rows)


def world_text(names: Sequence[str], embeddings=None, synonyms: bool = True) -> np.ndarray:
    """The (1, K, E) text of the classes ``names``, rows L2-normalized: ``embeddings`` a (K, E) array, list or
    tensor, or a ``{name: vector}`` dict or ``.npz`` table resolved against ``names`` ("/" synonyms averaged);
    else hashed n-gram vectors, with a warning: with ``synonyms`` (the trainer's) the mean over each name's "/"
    synonyms, without (``set_classes``') of each whole name, as the JAX package makes them. Any shape other
    than (K, E) raises."""
    from bsyolo_tpu_torch.utils import LOGGER

    emb = embeddings
    if hasattr(emb, "detach"):  # a tensor
        emb = emb.detach().cpu().float().numpy()
    elif emb is not None and not hasattr(emb, "ndim") and not isinstance(emb, (list, tuple)):
        emb = resolve_text_embeddings(names, emb)
    if emb is None:
        LOGGER.warning("no text embeddings given: using hashed n-gram vectors (NOT CLIP, lexical only; pass "
                       "CLIP embeddings for semantically meaningful open-vocab detection)")
        emb = (np.stack([hashed_text_embeddings(str(n).split("/")).mean(0) for n in names]) if synonyms
               else hashed_text_embeddings(names))
    emb = np.asarray(emb, np.float32)
    if emb.ndim != 2 or emb.shape[0] != len(names):
        raise ValueError(f"text embeddings must be ({len(names)}, embed); got {emb.shape}")
    return (emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-12))[None]
