"""Selection and per-label editing."""
