"""The halo tiler's own host time: median of the summed self time of the
spans `tiler.split` (cutting the tiles, padding the last chunk) and
`tiler.stitch` (untiling) per `engine_restorer.call`, from the program's
own recorder (host clock)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms("engine_restorer.call", ["tiler.split", "tiler.stitch"])
