"""Per-layer metrics: one reader a metric, ``read(reading) -> float | None``
(``harness.Reading``); ``None`` where the trace holds nothing to read. A
kernel's roofline reader takes the kernel's least time from
``reading.frames``, the reference's count of each frame's work, by the
rules and peaks of :mod:`benchmark.counts` or rules of its own, so a new one
is a file of its own."""
