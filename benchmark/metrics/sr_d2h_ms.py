"""The ×4 output's way back: median time of the span
`engine_restorer.d2h` per `engine_restorer.call`, from the program's own
recorder (host clock): the wait for the engine and the stitch on the
device, then the copy into pageable host memory."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms("engine_restorer.call", ["engine_restorer.d2h"])
