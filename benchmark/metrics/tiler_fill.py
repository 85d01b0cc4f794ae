"""Real tiles over the tiles the halo tiler handed to the engine, padding
included, over the whole run: 100 · (`tiler.tiles` − `tiler.pad_tiles`)
/ `tiler.tiles`, the tiler's own counters (`parallel/tiling.py`)."""

from benchmark.harness.spans import counters


def read(rec):
    c = counters()
    tiles = c.get("tiler.tiles")
    if not tiles:
        return None
    return 100.0 * (tiles - c.get("tiler.pad_tiles", 0)) / tiles
