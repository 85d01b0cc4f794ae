"""One caller, `restore_batch_u8` on batches of `batch` RGB uint8 crops
drawn in turn from a seeded pool of `pool` (a Restorer's batch entry)."""

import math

import numpy as np

from benchmark.harness.compare import worst_block_mean
from benchmark.harness.loop import ClosedLoop
from benchmark.harness.weights import smooth_images


class Driver(ClosedLoop):
    def __init__(self, program, traffic, seed, device, seconds):
        super().__init__(program, traffic, seed, device, seconds)
        t = traffic
        t.setdefault("answers_per_call", t["batch"])
        pool = smooth_images(t["pool"], t["height"], t["width"], seed,
                             "pool", self.device).cpu().numpy()
        n_batches = t["pool"] // math.gcd(t["pool"], t["batch"])
        self.batches = [np.ascontiguousarray(
            pool[(np.arange(t["batch"]) + i * t["batch"]) % t["pool"]])
            for i in range(n_batches)]

    def _call(self, i):
        k = i % len(self.batches)
        out = self.program.restore_batch_u8(self.batches[k])
        return (k, out), len(out)

    def check(self, reference) -> dict:
        """The worst mean gap over one image of the sampled calls."""
        worst = 0.0
        for k, out in self.keep.items:
            want = reference.restore_batch_u8(self.batches[k])
            worst = max(worst, worst_block_mean(out, want, out.shape[1]))
        return {"image_mean_lsb": worst}
