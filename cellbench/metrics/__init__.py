"""One reader a metric: ``<metric name>.py`` defines ``read(run)``, which
returns the metric's value from the run (``cellbench/run.Run``) or None
where the run holds nothing to read. A metric with no reader of its own
takes the reader of its name's stem before the first dot
(``device_idle.fit`` -> ``device_idle.py``). Modules whose names start
with ``_`` are shared arithmetic, not metrics."""
