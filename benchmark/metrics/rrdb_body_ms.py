"""The host's time in the RRDB blocks of one call: median over the
recorded `engine_restorer.call`s of the span `rrdb.body` (issuing the 23
blocks' 345 K2 launches and the glue between them), from the program's own
recorder (host clock). The host blocks once CUDA's launch queue is full,
so where the blocks' device work outlasts their issue this reads about
that device time."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms("engine_restorer.call", ["rrdb.body"])
