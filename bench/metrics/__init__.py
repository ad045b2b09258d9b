"""Per-layer metrics, one module each, found by the metric's name in
``BENCHMARK.json``. A module holds ``read(ctx) -> float | None``; ``ctx``
is the traced run's context (``harness.run_cell``): the cell, its
configuration, its ops with their query pools, the calls of the window,
the reference as the window left it, and the device trace. A reader
that finds nothing to read returns None, and the metric is left out."""
