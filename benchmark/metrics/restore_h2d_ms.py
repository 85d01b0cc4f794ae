"""The restore's input copy: median time of the span `restorer.h2d` (the
pageable uint8 batch to the device) per `restorer.restore_batch_u8`
call, from the program's own recorder (host clock)."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms("restorer.restore_batch_u8", ["restorer.h2d"])
