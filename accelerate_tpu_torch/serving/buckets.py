"""Bucketed shapes for the serving engine: a copy of
``accelerate_tpu.serving.buckets``.

The JAX engine compiles only at lattice shapes. The port runs eagerly, so
nothing here bounds a compile cache; the lattice still decides the shapes
every step runs at — the prefill chunk length (largest bucket) and padding,
the decode batch and table widths — so the port's engine walks exactly the
same shapes, chunks and padded writes as the reference, and the kernels are
launched at the shapes the main path gives them. The points
(:meth:`BucketLattice.decode_points`, :meth:`~BucketLattice.prefill_points`)
are what the engine's ``warmup`` runs once each.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["BucketLattice"]


def _pow2_buckets(max_value: int, floor: int = 1) -> "tuple[int, ...]":
    """Powers of two from ``floor`` up to and including ``max_value`` (the max
    itself is appended when it is not a power of two)."""
    if max_value < 1:
        raise ValueError(f"max_value must be >= 1, got {max_value}")
    buckets = []
    b = max(1, floor)
    while b < max_value:
        buckets.append(b)
        b *= 2
    buckets.append(max_value)
    return tuple(buckets)


@dataclass(frozen=True)
class BucketLattice:
    """- ``slot_buckets``: decode batch sizes (live batch slots rounded up);
    - ``block_buckets``: per-sequence block-table widths;
    - ``prefill_buckets``: padded prefill chunk lengths.

    ``bucket_for`` rounds a live value up to the smallest covering bucket and
    refuses values beyond the lattice."""

    slot_buckets: "tuple[int, ...]"
    block_buckets: "tuple[int, ...]"
    prefill_buckets: "tuple[int, ...]"

    def __post_init__(self):
        for name in ("slot_buckets", "block_buckets", "prefill_buckets"):
            buckets = getattr(self, name)
            if not buckets or list(buckets) != sorted(set(buckets)):
                raise ValueError(f"{name} must be non-empty, sorted, unique: {buckets}")

    @classmethod
    def from_limits(cls, max_slots: int, max_blocks_per_seq: int, max_prefill_len: int,
                    *, min_prefill_len: int = 8) -> "BucketLattice":
        """Power-of-two lattice covering the engine's configured limits."""
        return cls(
            slot_buckets=_pow2_buckets(max_slots),
            block_buckets=_pow2_buckets(max_blocks_per_seq),
            prefill_buckets=_pow2_buckets(max_prefill_len, floor=min_prefill_len),
        )

    @staticmethod
    def bucket_for(value: int, buckets: "tuple[int, ...]") -> int:
        """Smallest bucket >= ``value``; ValueError beyond the lattice."""
        for b in buckets:
            if value <= b:
                return b
        raise ValueError(
            f"value {value} exceeds the bucket lattice (max {buckets[-1]}); "
            "raise the engine limit this lattice was built from"
        )

    def slot_bucket(self, n_slots: int) -> int:
        return self.bucket_for(max(1, n_slots), self.slot_buckets)

    def block_bucket(self, n_blocks: int) -> int:
        return self.bucket_for(max(1, n_blocks), self.block_buckets)

    def prefill_bucket(self, prompt_len: int) -> int:
        return self.bucket_for(max(1, prompt_len), self.prefill_buckets)

    def decode_points(self) -> "list[tuple[int, int]]":
        """All (slot, block) decode points, for warmup."""
        return [(s, b) for s in self.slot_buckets for b in self.block_buckets]

    def prefill_points(self) -> "list[tuple[int, int]]":
        """All (prefill_len, block) prefill points: a prefill always runs at
        the widest block bucket, so one width per chunk length."""
        widest = self.block_buckets[-1]
        return [(s, widest) for s in self.prefill_buckets]

    def size(self) -> int:
        """Decode points plus prefill points."""
        return len(self.decode_points()) + len(self.prefill_points())

    def warmup_points(self, prefix_cache: bool = False, spec_decode: bool = False) -> int:
        """Points ``ServingEngine.warmup`` visits: the lattice, one
        copy-on-write point with prefix caching, and with speculative
        decoding one draft and one verify point per decode point."""
        extra = 2 * len(self.decode_points()) if spec_decode else 0
        return self.size() + (1 if prefix_cache else 0) + extra
