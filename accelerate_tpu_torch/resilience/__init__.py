"""Elastic training, the port of ``accelerate_tpu.resilience``: only the
topology guard a checkpoint load needs (:mod:`.reshard`) so far; the rest
is ROADMAP.md Queue A item 12."""
