"""Share of the traced window with no kernel, copy or set on the device."""

from benchmark.harness.readers import idle_percent


def read(rec):
    return idle_percent(rec)
