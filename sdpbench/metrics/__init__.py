"""Metric readers, one file each, found by the metric's name in
BENCHMARK.json (see ``sdpbench.record``)."""
