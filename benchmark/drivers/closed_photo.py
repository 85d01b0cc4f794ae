"""One caller, `__call__` on RGB uint8 photos of `height` × `width` drawn
in turn from a seeded pool of `pool` (an EngineRestorer). The engine's
`serve` is wrapped to count the tiles it is handed; the work counted is
the photos' cells of a fixed `grid_tile` grid, whatever tile the engine
cuts."""

import math

from benchmark.harness.compare import worst_block_mean
from benchmark.harness.loop import ClosedLoop
from benchmark.harness.weights import smooth_images


class Driver(ClosedLoop):
    def __init__(self, program, traffic, seed, device, seconds):
        super().__init__(program, traffic, seed, device, seconds)
        t = traffic
        t.setdefault("answers_per_call", 1)
        self.pool = smooth_images(t["pool"], t["height"], t["width"], seed,
                                  "pool", self.device,
                                  cell=t.get("cell", 16)).cpu().numpy()
        self.engine_calls = self.engine_tiles = 0
        serve = getattr(program, "serve", None)
        if serve is not None:  # the control has no engine to count
            def counted(x):
                self.engine_calls += 1
                self.engine_tiles += int(x.shape[0])
                return serve(x)
            program.serve = counted
        g = t["grid_tile"]
        self.tiles_per_photo = (math.ceil(t["height"] / g)
                                * math.ceil(t["width"] / g))

    def _call(self, i):
        k = i % len(self.pool)
        return (k, self.program(self.pool[k])), 1

    def _reset_counters(self):
        self.engine_calls = self.engine_tiles = 0

    def _counters(self):
        return {"engine_calls": self.engine_calls,
                "engine_tiles": self.engine_tiles}

    def window(self, seconds, tracer, started):
        rec = super().window(seconds, tracer, started)
        rec["real_tiles"] = rec["answers"] * self.tiles_per_photo
        if rec["traced"] is not None:
            rec["traced"]["real_tiles"] = (rec["traced"]["answers"]
                                           * self.tiles_per_photo)
        return rec

    def check(self, reference) -> dict:
        """The worst mean gap over one `check_block`² block of the sampled
        photos' ×r outputs."""
        worst = 0.0
        for k, out in self.keep.items:
            want = reference(self.pool[k])
            worst = max(worst, worst_block_mean(out, want,
                                                self.t["check_block"]))
        return {"block_mean_lsb": worst}
