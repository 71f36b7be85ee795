"""Metric readers, one file a metric, found by the metric's name.

Each defines `read(rec) -> float | None` over the run's record
(`sfu_bench.core.RunRecord`). A reader that finds nothing to read returns
None and the harness leaves the metric out of the result line.
"""
