"""Dynamic micro-batching for concurrent serving requests.

Port of `image_restoration_tpu/serve/batching.py:41-304` (numpy and threads
only, no device code). Throughput of the GPU rises with batch size while the
reference servers dispatch every HTTP request as its own forward
(Car_Plate-Restoration/api.py:125-151, api_plate_oto.py:404-489).
`MicroBatcher` coalesces requests that arrive within a short window into one
padded call and fans the results back out to the callers.

Batches are padded up to a fixed bucket ladder (powers of two by default),
so the forward sees a bounded set of shapes and never one per arrival
pattern. Padding replicates the last real item. In the port's server the
`batch_fn` hands its work to the one restore thread (cuDNN's plans are
cached per thread), so device work never runs on the batcher's threads.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np

_SENTINEL = object()


def _default_buckets(max_batch: int) -> tuple:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class MicroBatcher:
    """Coalesce concurrent `submit()` calls into batched `batch_fn` calls.

    Dispatches are PIPELINED: up to `pipeline_depth` batches are in flight
    concurrently, so the gather loop keeps draining arrivals while a prior
    batch's device round-trip (dispatch + result transfer) completes.

    Batching policy ("natural batching"): arrivals are drained greedily;
    the `max_wait_ms` hold applies ONLY when no batch is in flight (an
    in-flight dispatch already provides a coalescing window for free, so
    waiting on top of it would just add latency). A `min_fill` floor stops
    the free-slot early-ship from dispatching starved (size-1/2) batches:
    below the floor the dispatcher keeps waiting out the window, and the
    window is refreshed whenever the pipeline is saturated (time spent
    blocked on a full pipeline is free coalescing, not hold latency).

    Args:
        batch_fn: maps a stacked (N, ...) array to an (N, ...) result array.
            With pipeline_depth == 1 it is called from one dispatch thread
            only; with pipeline_depth > 1 it may be called from up to that
            many threads concurrently (host-stateful batch_fns must pass
            pipeline_depth=1; the port's server hands each call to its one
            restore thread).
        max_batch: hard cap per dispatch (and largest bucket).
        max_wait_ms: how long the dispatcher holds the FIRST request of a
            batch while waiting for more to arrive, when the device is
            idle. Latency cost under low concurrency; under load the
            window closes as soon as max_batch is reached or a pipeline
            slot frees up.
        buckets: ascending pad targets; batches are padded up to the next
            bucket so the forward sees a bounded shape set. Default: powers
            of two up to max_batch.
        stack: True (default) stacks same-shape items into one (N, ...)
            array and pads to a bucket. False passes the raw item LIST to
            batch_fn and expects a same-length sequence back — for
            consumers that handle heterogeneous shapes and their own
            padding, e.g. PlatePipeline.process_batch.
        pipeline_depth: max concurrently in-flight batch_fn calls.
        min_fill: smallest batch the free-slot early-ship may dispatch
            (the wait-window expiry may still ship smaller). Default
            max_batch // 4. Keeps a freed pipeline slot from draining
            one-item batches onto a dispatch path whose per-call overhead
            dwarfs per-item cost.
    """

    def __init__(self, batch_fn: Callable[[np.ndarray], np.ndarray],
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 buckets: Optional[Sequence[int]] = None,
                 stack: bool = True, pipeline_depth: int = 2,
                 min_fill: Optional[int] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.batch_fn = batch_fn
        self.stack = stack
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.buckets = tuple(sorted(buckets)) if buckets else \
            _default_buckets(self.max_batch)
        if self.buckets[-1] < self.max_batch:
            raise ValueError("largest bucket must cover max_batch")
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.min_fill = max(1, self.max_batch // 4) if min_fill is None \
            else max(1, min(int(min_fill), self.max_batch))
        self.stats = {"items": 0, "dispatches": 0, "padded_rows": 0,
                      "batch_hist": {}}
        self._q: queue.Queue = queue.Queue()
        self._shape = None
        self._lock = threading.Lock()
        self._inflight = 0
        self._pool = ThreadPoolExecutor(
            max_workers=self.pipeline_depth,
            thread_name_prefix="microbatch-dispatch")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        self._thread.start()

    # ---- client side ----
    def submit(self, item: np.ndarray) -> Future:
        item = np.asarray(item)
        if self.stack:
            with self._lock:
                if self._shape is None:
                    self._shape = item.shape
                elif item.shape != self._shape:
                    raise ValueError(
                        f"item shape {item.shape} != batcher shape "
                        f"{self._shape}; resize before submitting")
        fut: Future = Future()
        self._q.put((item, fut))
        return fut

    def __call__(self, item: np.ndarray, timeout: Optional[float] = None):
        return self.submit(item).result(timeout)

    def stop(self):
        self._q.put(_SENTINEL)
        self._thread.join(timeout=30)

    # ---- dispatcher side ----
    def _run(self):
        stop = False
        while not stop:
            entry = self._q.get()
            if entry is _SENTINEL:
                break
            batch = [entry]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                try:
                    entry = self._q.get_nowait()
                except queue.Empty:
                    with self._lock:
                        inflight = self._inflight
                    if inflight >= self.pipeline_depth:
                        # every pipeline slot is busy: dispatching now
                        # would only queue behind them — keep draining
                        # arrivals instead (free coalescing window), and
                        # refresh the hold window so a freed slot doesn't
                        # inherit an already-expired deadline
                        deadline = time.monotonic() + self.max_wait_s
                        time.sleep(2e-4)
                        continue
                    if inflight > 0 and len(batch) >= self.min_fill:
                        # a slot is free, work is in flight, and the
                        # batch is reasonably full: ship it to overlap
                        # with the in-flight work; waiting longer only
                        # adds latency (the next batch coalesces while
                        # this one round-trips). Below min_fill, fall
                        # through to the timed wait instead of feeding
                        # the dispatch path starved batches.
                        break
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        entry = self._q.get(timeout=timeout)
                    except queue.Empty:
                        break
                if entry is _SENTINEL:
                    stop = True
                    break
                batch.append(entry)
            with self._lock:
                self._inflight += 1
            self._pool.submit(self._dispatch, batch)
        self._pool.shutdown(wait=True)

    def _dispatch(self, batch):
        try:
            self._dispatch_inner(batch)
        finally:
            with self._lock:
                self._inflight -= 1

    def _dispatch_inner(self, batch):
        futs = [b[1] for b in batch]
        n = len(futs)
        bucket = next(b for b in self.buckets if b >= n)
        try:
            if self.stack:
                items = np.stack([b[0] for b in batch])
                if bucket > n:
                    pad = np.repeat(items[-1:], bucket - n, axis=0)
                    items = np.concatenate([items, pad], axis=0)
                out = np.asarray(self.batch_fn(items))[:n]
            else:  # list mode: the consumer pads/chunks itself
                bucket = n
                out = self.batch_fn([b[0] for b in batch])
                if len(out) != n:
                    raise RuntimeError(
                        f"batch_fn returned {len(out)} results for {n} "
                        "items")
        except Exception as exc:  # fan the failure out to every caller
            for f in futs:
                try:
                    f.set_exception(exc)
                except Exception:
                    pass  # caller cancelled; must not kill the dispatcher
            return
        with self._lock:
            self.stats["items"] += n
            self.stats["dispatches"] += 1
            self.stats["padded_rows"] += bucket - n
            hist = self.stats["batch_hist"]
            hist[bucket] = hist.get(bucket, 0) + 1
        for f, o in zip(futs, out):
            try:
                f.set_result(o)
            except Exception:
                pass  # caller cancelled; must not kill the dispatcher


def calibrate(batch_fn: Callable[[np.ndarray], np.ndarray],
              item: np.ndarray, max_batch: int = 32,
              concurrency: int = 16, repeats: int = 3,
              margin: float = 1.05) -> dict:
    """Measure whether coalescing wins on this host and device.

    Micro-batching trades per-dispatch overhead against serialization: it
    wins when the device's batch-size scaling exceeds what concurrent
    per-request dispatches already recover by overlapping. Which regime a
    deployment is in is measured here, not assumed.

    Times two arms with the same warmed `batch_fn`:
      per_request — `concurrency` threads each dispatching one item
          concurrently (the reference servers' behavior under load,
          Car_Plate-Restoration/api.py:125-151);
      batched — one `max_batch`-size dispatch (the steady-state
          micro-batcher dispatch; pipelining only raises this).

    Returns a dict with both rates, their ratio, and
    ``recommend`` = batched beats per_request by ≥ `margin`.
    """
    item = np.asarray(item)
    one = item[None]
    full = np.repeat(one, max_batch, axis=0)
    batch_fn(one)  # warm both shapes (cuDNN plans) outside timing
    batch_fn(full)

    per_req_rate = 0.0
    for _ in range(repeats):
        barrier = threading.Barrier(concurrency + 1)

        def worker():
            barrier.wait()
            batch_fn(one)

        threads = [threading.Thread(target=worker)
                   for _ in range(concurrency)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.monotonic()
        for t in threads:
            t.join()
        per_req_rate = max(per_req_rate,
                           concurrency / (time.monotonic() - t0))

    batched_rate = 0.0
    for _ in range(repeats):
        t0 = time.monotonic()
        batch_fn(full)
        batched_rate = max(batched_rate,
                           max_batch / (time.monotonic() - t0))

    speedup = batched_rate / max(per_req_rate, 1e-9)
    return {
        "per_request_imgs_per_s": round(per_req_rate, 2),
        "batched_imgs_per_s": round(batched_rate, 2),
        "speedup": round(speedup, 3),
        "concurrency": concurrency,
        "max_batch": max_batch,
        "margin": margin,
        "recommend": bool(speedup >= margin),
    }
