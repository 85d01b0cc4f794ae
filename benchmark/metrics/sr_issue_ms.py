"""The host's time to issue the SR engine: median of the summed spans
`tiler.run` (each chunk's engine call) per `engine_restorer.call`, from
the program's own recorder (host clock)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms("engine_restorer.call", ["tiler.run"])
