"""The ×4 outputs copied into page-locked host memory over all
`EngineRestorer` calls of the run: 100 · `engine_restorer.pinned_out` /
(`engine_restorer.pinned_out` + `engine_restorer.pageable_out`), the
output path's own counters (`serve/engine_restorer.py`)."""

from benchmark.harness.spans import counters


def read(rec):
    c = counters()
    pinned = c.get("engine_restorer.pinned_out", 0)
    calls = pinned + c.get("engine_restorer.pageable_out", 0)
    if not calls:
        return None
    return 100.0 * pinned / calls
