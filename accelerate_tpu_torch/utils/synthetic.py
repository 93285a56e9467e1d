"""Synthetic MRPC-shaped data: this package's copy of ``make_synthetic_mrpc``
and ``DictDataset`` from the repository's ``examples/nlp_example.py``, the
data of the JAX package's headline BERT benchmark. Same numpy draws from
the same seed, so both packages train on identical batches."""

from __future__ import annotations

import numpy as np

__all__ = ["DictDataset", "make_synthetic_mrpc"]


def make_synthetic_mrpc(n: int, seq_len: int, vocab: int, seed: int = 0) -> dict:
    """A learnable classification task with MRPC's tensor shapes: a keyword
    token is planted at positions 1-4 and the label is a function of its
    identity; ``[CLS]`` (id 1) at position 0; no padding."""
    rng = np.random.default_rng(seed)
    half = seq_len // 2
    ids = rng.integers(10, vocab, size=(n, seq_len), dtype=np.int32)
    token_type = np.concatenate(
        [np.zeros((n, half), np.int32), np.ones((n, seq_len - half), np.int32)], axis=1
    )
    keywords = rng.integers(2, 10, size=n, dtype=np.int32)
    labels = (keywords >= 6).astype(np.int32)
    for pos in (1, 2, 3, 4):
        ids[:, pos] = keywords
    ids[:, 0] = 1
    mask = np.ones((n, seq_len), np.int32)
    return {"input_ids": ids, "token_type_ids": token_type, "attention_mask": mask,
            "labels": labels}


class DictDataset:
    """Map-style dataset over a dict of equal-length arrays."""

    def __init__(self, data: dict):
        self.data = data

    def __len__(self) -> int:
        return len(self.data["labels"])

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.data.items()}
