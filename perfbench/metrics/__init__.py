"""Per-layer metric readers, found by the metric's name in
``BENCHMARK.json``: ``<name>.py`` with ``.`` as ``_``, else the module of
the name before its first dot, which every cell's variant of a metric
shares (``idle_share.batch`` and ``idle_share.ptq`` read ``idle_share.py``). Each has ``read(session)``,
which returns the number or None when the run gives it nothing to read
(the harness then leaves the metric out of the line)."""
