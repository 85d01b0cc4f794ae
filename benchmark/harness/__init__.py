"""The general part of the benchmark: spec resolution, program builders,
traffic drivers, tracing and the comparison that decides `correct`."""
