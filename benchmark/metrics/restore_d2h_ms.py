"""The restore's way back: median time of the span `restorer.d2h` per
`restorer.restore_batch_u8` call, from the program's own recorder (host
clock): the wait for the forward's tail on the device, then the copy
into pageable host memory."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms("restorer.restore_batch_u8", ["restorer.d2h"])
