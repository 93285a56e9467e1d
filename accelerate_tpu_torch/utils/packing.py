"""Sequence packing: the port of ``accelerate_tpu.utils.packing`` (numpy,
an own copy: the port imports nothing of the JAX package).

Several variable-length documents share one fixed-length row; per-token
``segment_ids`` tell ``llama_forward(segment_ids=...)`` to mask
cross-document attention and restart RoPE positions per document, and
``llama_loss`` to drop boundary and padding targets.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

__all__ = ["pack_sequences", "unpack_logits"]


def pack_sequences(sequences: Iterable[Sequence[int]], seq_len: int, pad_id: int = 0,
                   split_long: bool = True):
    """Greedily pack token sequences into rows of exactly ``seq_len``.

    Returns ``(input_ids, segment_ids)`` int32 arrays ``[N, seq_len]``:
    ``segment_ids`` numbers each document 1..k within its row, 0 = padding.
    Documents longer than ``seq_len`` are cut into chunks, one segment each
    (``split_long=True``), or rejected; empty documents are rejected. Shelf
    packing (append to the open row, open a new one when it is full) keeps
    the input order, so :func:`unpack_logits` maps back 1:1 when no
    document was cut."""
    chunks: list[list[int]] = []
    for i, seq in enumerate(sequences):
        seq = list(seq)
        if not seq:
            raise ValueError(f"sequence {i} is empty — filter empties out first (a silent "
                             "skip would misalign unpack_logits with the input list)")
        if len(seq) > seq_len:
            if not split_long:
                raise ValueError(f"sequence of {len(seq)} tokens exceeds seq_len={seq_len}")
            chunks.extend(seq[j : j + seq_len] for j in range(0, len(seq), seq_len))
        else:
            chunks.append(seq)

    rows: list[list[list[int]]] = []
    used = seq_len  # force a new row for the first chunk
    for chunk in chunks:
        if used + len(chunk) > seq_len:
            rows.append([])
            used = 0
        rows[-1].append(chunk)
        used += len(chunk)

    input_ids = np.full((len(rows), seq_len), pad_id, dtype=np.int32)
    segment_ids = np.zeros((len(rows), seq_len), dtype=np.int32)
    for r, row in enumerate(rows):
        pos = 0
        for s, chunk in enumerate(row, start=1):
            input_ids[r, pos : pos + len(chunk)] = chunk
            segment_ids[r, pos : pos + len(chunk)] = s
            pos += len(chunk)
    return input_ids, segment_ids


def unpack_logits(logits, segment_ids):
    """Split packed per-token outputs ``[N, S, ...]`` back into a list of
    per-document ``[len_i, ...]`` arrays in row-major segment order (the
    input order of :func:`pack_sequences`)."""
    logits = np.asarray(logits)
    segment_ids = np.asarray(segment_ids)
    docs = []
    for r in range(segment_ids.shape[0]):
        for s in range(1, int(segment_ids[r].max(initial=0)) + 1):
            sel = segment_ids[r] == s
            if sel.any():
                docs.append(logits[r][sel])
    return docs
