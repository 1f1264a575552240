"""One module a metric, named as the metric is in ``BENCHMARK.json``. Each
has ``read(run)``, which takes the run's record (``window``: the timed jobs;
``setup_s``; ``trace``: the traced run's summary from
:func:`portbench.trace.summarize`, or None) and returns the number, or None
where it finds nothing to read."""
