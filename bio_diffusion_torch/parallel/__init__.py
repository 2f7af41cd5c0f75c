"""Data parallelism across processes (one rank a card) and across the cards
of one process (sampling replicas): ``parallel.distributed``."""
