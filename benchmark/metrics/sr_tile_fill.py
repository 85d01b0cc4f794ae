"""Real tiles over the tiles handed to the engine's `serve` in the window
(the harness's counting wrapper round `serve`): what the halo tiler's
zero padding of each engine call wastes."""


def read(rec):
    handed = rec["work"].get("engine_tiles")
    return 100.0 * rec["real_tiles"] / handed if handed else None
