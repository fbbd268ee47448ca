"""Request micro-batcher with admission control (port of
``predictionio_tpu/serving/batcher.py``; the reference's AOT bucket set
waits for its slice).

One worker thread owns a FIFO of pending items. A batch flushes when
``max_batch_size`` items are queued or the OLDEST item has waited
``max_delay_ms``. The flush callback gets the whole batch and returns
one result per item; request threads block on their item's event. When
the queue already holds ``max_queue`` items, ``submit`` raises
:class:`ServerSaturated` (the server answers 503 + Retry-After).

Stats are REGISTRY-BACKED (common/telemetry.py): batch/query/reject
counts, batch-size and padding-bucket histograms, queue-wait totals and
flush latency live as labeled instruments in the process-wide metrics
registry. ``GET /metrics`` scrapes them and the engine server's ``GET /``
derives its ``batching`` block from the same instruments, byte for byte
as before. Each batcher instance gets its own label, so a fresh batcher
starts from zero.

Tracing and waterfalls (common/tracing.py, common/waterfall.py): a
submitting request's trace context and waterfall record ride its
``_Pending`` onto the worker thread, which records the item's
``admission`` span and stage (enqueue -> batch formation, timed off the
request thread) and wraps the flush in a ``flush`` span parented on the
head item's trace. The flush callback's own stages record into every
sampled rider of the batch. The flush runs inside
``devicewatch.serving_region``, so a kernel build or load on the serving
path after warmup is the alarm, and each flush counts toward warmup.
Flush timing ends in the ``.cpu()`` copy of the top-k result, so it
times the kernels and not their launch.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from predictionio_tpu_torch.common import (
    devicewatch, telemetry, tracing, waterfall,
)
from predictionio_tpu_torch.serving.protocol import bucket_for, pad_buckets

#: distinguishes concurrently-live batchers in the process-wide
#: registry; the label value is f"{name}#{seq}"
_instance_seq = itertools.count()

#: flush latency buckets: sub-ms flushes through multi-second dispatches
_FLUSH_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                  0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


class ServerSaturated(Exception):
    """Queue depth hit max_queue; carries the 503 Retry-After hint."""

    def __init__(self, retry_after_s: int):
        super().__init__(
            f"serving queue saturated; retry after ~{retry_after_s}s")
        self.retry_after_s = retry_after_s


class _Pending:
    __slots__ = ("item", "t_enq", "done", "result", "error", "trace",
                 "rec")

    def __init__(self, item: Any, t_enq: float,
                 trace: Optional["tracing.TraceContext"] = None,
                 rec: Optional["waterfall.RequestRecord"] = None):
        self.item = item
        self.t_enq = t_enq
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        #: the submitting request's trace context: the worker records
        #: this item's admission span under it and parents the batch's
        #: flush span on the head item's
        self.trace = trace
        #: the submitting request's waterfall record: the worker credits
        #: this item's admission wait to it and the flush-level stages
        #: record into every record of the batch
        self.rec = rec


class BatcherClosed(RuntimeError):
    """submit() on a batcher whose close() began: the item was never
    queued, so the caller may hand it to another batcher."""


class MicroBatcher:
    """Coalesces concurrent submit() calls into flush_fn(list) batches."""

    def __init__(self, flush_fn: Callable[[List[Any]], Sequence[Any]],
                 max_batch_size: int = 64,
                 max_delay_ms: float = 2.0,
                 max_queue: int = 256,
                 name: str = "query-batcher"):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self._flush_fn = flush_fn
        self.name = name
        self.max_batch_size = int(max_batch_size)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.max_queue = int(max_queue)
        self.buckets = pad_buckets()
        self._cond = threading.Condition()
        self._q: List[_Pending] = []
        self._closed = False
        reg = telemetry.registry()
        inst = {"batcher": f"{name}#{next(_instance_seq)}"}
        self._m_batches = reg.counter(
            "pio_batcher_batches_total", "Flushed batches",
            labelnames=("batcher",)).labels(**inst)
        self._m_queries = reg.counter(
            "pio_batcher_queries_total", "Queries admitted into batches",
            labelnames=("batcher",)).labels(**inst)
        self._m_rejected = reg.counter(
            "pio_batcher_rejected_total",
            "Queries rejected by admission control (503)",
            labelnames=("batcher",)).labels(**inst)
        self._m_queue_wait = reg.counter(
            "pio_batcher_queue_wait_seconds_total",
            "Summed per-query queue wait", labelnames=("batcher",)
        ).labels(**inst)
        self._m_flush = reg.histogram(
            "pio_batcher_flush_seconds",
            "Flush (device dispatch) latency per batch; the timed region "
            "ends in the host copy of the top-k result",
            labelnames=("batcher",), buckets=_FLUSH_BUCKETS).labels(**inst)
        self._m_depth = reg.gauge(
            "pio_batcher_queue_depth", "Current admission queue depth",
            labelnames=("batcher",)).labels(**inst)
        self._size_fam = reg.counter(
            "pio_batcher_batch_size", "Batches by exact flush size",
            labelnames=("batcher", "size"))
        self._bucket_fam = reg.counter(
            "pio_batcher_bucket", "Batches by padding-bucket occupancy",
            labelnames=("batcher", "bucket"))
        self._inst = inst
        self._size_children: Dict[int, Any] = {}
        self._bucket_children: Dict[int, Any] = {}
        self._worker = threading.Thread(
            target=self._run, name=name, daemon=True)
        self._worker.start()

    def submit(self, item: Any) -> Any:
        """Enqueue one item and block until its batch is served. Raises
        ServerSaturated when the queue is full, BatcherClosed once closed,
        and re-raises what the flush callback raised for this batch."""
        trace = tracing.current()
        rec = waterfall.current()
        with self._cond:
            if self._closed:
                raise BatcherClosed("batcher is closed")
            if len(self._q) >= self.max_queue:
                self._m_rejected.inc()
                raise ServerSaturated(self._retry_after_locked())
            pending = _Pending(item, time.monotonic(), trace=trace,
                               rec=rec)
            self._q.append(pending)
            self._m_depth.set(len(self._q))
            self._cond.notify_all()
        pending.done.wait()
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _retry_after_locked(self) -> int:
        """Drain-time estimate for the current backlog, floored at 1 s."""
        batches = self._m_flush.count
        if batches:
            per_batch = self._m_flush.sum / batches
            est = (len(self._q) / self.max_batch_size + 1.0) * per_batch
        else:
            est = 1.0
        return max(1, int(est + 0.999))

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._closed:
                    self._cond.wait()
                if not self._q:     # closed and drained
                    return
                deadline = self._q[0].t_enq + self.max_delay_s
                while (len(self._q) < self.max_batch_size
                       and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                batch = self._q[:self.max_batch_size]
                del self._q[:len(batch)]
                now = time.monotonic()
                bucket = bucket_for(len(batch), self.buckets)
                self._m_batches.inc()
                self._m_queries.inc(len(batch))
                self._size_child(len(batch)).inc()
                self._bucket_child(bucket).inc()
                self._m_queue_wait.inc(sum(now - p.t_enq for p in batch))
                self._m_depth.set(len(self._q))
            # per-item admission spans and stages: enqueue -> batch
            # formation, under each submitter's own trace and record
            head_ctx = None
            for p in batch:
                if p.trace is not None:
                    if head_ctx is None:
                        head_ctx = p.trace
                    tracing.record_span("admission", p.trace,
                                        now - p.t_enq, service=self.name)
                if p.rec is not None:
                    waterfall.observe_stage("admission", now - p.t_enq,
                                            (p.rec,))
            recs = [p.rec for p in batch if p.rec is not None]
            for r in recs:
                r.note("bucket", bucket)
                r.note("batchSize", len(batch))
            t0 = time.monotonic()
            try:
                with devicewatch.serving_region(
                        "serve_flush",
                        signature=f"bucket={bucket},n={len(batch)}"):
                    with tracing.activate(head_ctx):
                        with tracing.span("flush", service=self.name):
                            with waterfall.activate(recs):
                                results = self._flush_fn(
                                    [p.item for p in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"flush returned {len(results)} results for a "
                        f"batch of {len(batch)}")
                for p, r in zip(batch, results):
                    p.result = r
            except BaseException as e:  # every waiter gets the error
                for p in batch:
                    p.error = e
            self._m_flush.observe(time.monotonic() - t0)
            devicewatch.note_serving_flush()
            for p in batch:
                p.done.set()

    def _size_child(self, n: int):
        c = self._size_children.get(n)
        if c is None:
            c = self._size_fam.labels(size=str(n), **self._inst)
            self._size_children[n] = c
        return c

    def _bucket_child(self, b: int):
        c = self._bucket_children.get(b)
        if c is None:
            c = self._bucket_fam.labels(bucket=str(b), **self._inst)
            self._bucket_children[b] = c
        return c

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def close(self, timeout: float = 5.0) -> None:
        """Stop accepting work; the worker drains the queue, then exits."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout)

    def stats(self) -> Dict[str, Any]:
        """The `GET /` batching block (the JAX package's key set), derived
        from the registry instruments (same keys, same arithmetic)."""
        with self._cond:
            depth = len(self._q)
            size_hist = {k: int(c.value)
                         for k, c in self._size_children.items()}
            bucket_hist = {k: int(c.value)
                           for k, c in self._bucket_children.items()}
        batches = int(self._m_batches.value)
        queries = int(self._m_queries.value)
        flush_s = self._m_flush.sum
        return {
            "maxBatchSize": self.max_batch_size,
            "maxDelayMs": self.max_delay_s * 1e3,
            "maxQueue": self.max_queue,
            "buckets": list(self.buckets),
            "queueDepth": depth,
            "batches": batches,
            "queries": queries,
            "rejected": int(self._m_rejected.value),
            "batchSizeHist": {str(k): v for k, v in
                              sorted(size_hist.items())},
            "bucketHist": {str(k): v for k, v in
                           sorted(bucket_hist.items())},
            "avgQueueWaitMs": (self._m_queue_wait.value / queries * 1e3
                               if queries else 0.0),
            "avgFlushMs": (flush_s / batches * 1e3 if batches else 0.0),
        }
