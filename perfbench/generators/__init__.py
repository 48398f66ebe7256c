"""Traffic generators, one module per ``kind`` of a traffic file. Each has
``run(bench) -> Outcome``: set-up, the measured window, and what the
harness needs after it (``perfbench.outcome.Outcome``)."""
