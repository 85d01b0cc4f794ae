"""The host's time to issue the GFPGAN forward: median time of the span
`restorer.forward` per `restorer.restore_batch_u8` call, from the
program's own recorder (host clock). Near the call's device time, the
host sets the pace."""

from benchmark.harness.spans import median_ms


def read(rec):
    return median_ms("restorer.restore_batch_u8", ["restorer.forward"])
