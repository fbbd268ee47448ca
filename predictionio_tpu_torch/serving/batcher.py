"""Request micro-batcher with admission control (port of
``predictionio_tpu/serving/batcher.py`` without its telemetry, tracing
and waterfall hooks, which arrive with the observability slice).

One worker thread owns a FIFO of pending items. A batch flushes when
``max_batch_size`` items are queued or the OLDEST item has waited
``max_delay_ms``. The flush callback gets the whole batch and returns
one result per item; request threads block on their item's event. When
the queue already holds ``max_queue`` items, ``submit`` raises
:class:`ServerSaturated` (the server answers 503 + Retry-After).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from predictionio_tpu_torch.serving.protocol import bucket_for, pad_buckets


class ServerSaturated(Exception):
    """Queue depth hit max_queue; carries the 503 Retry-After hint."""

    def __init__(self, retry_after_s: int):
        super().__init__(
            f"serving queue saturated; retry after ~{retry_after_s}s")
        self.retry_after_s = retry_after_s


class _Pending:
    __slots__ = ("item", "t_enq", "done", "result", "error")

    def __init__(self, item: Any, t_enq: float):
        self.item = item
        self.t_enq = t_enq
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None


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
        # stats, guarded by _cond
        self._batches = 0
        self._queries = 0
        self._rejected = 0
        self._queue_wait_s = 0.0
        self._flush_s = 0.0
        self._size_hist: Dict[int, int] = {}
        self._bucket_hist: Dict[int, int] = {}
        self._worker = threading.Thread(
            target=self._run, name=name, daemon=True)
        self._worker.start()

    def submit(self, item: Any) -> Any:
        """Enqueue one item and block until its batch is served. Raises
        ServerSaturated when the queue is full, RuntimeError once closed,
        and re-raises what the flush callback raised for this batch."""
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._q) >= self.max_queue:
                self._rejected += 1
                raise ServerSaturated(self._retry_after_locked())
            pending = _Pending(item, time.monotonic())
            self._q.append(pending)
            self._cond.notify_all()
        pending.done.wait()
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _retry_after_locked(self) -> int:
        """Drain-time estimate for the current backlog, floored at 1 s."""
        if self._batches:
            per_batch = self._flush_s / self._batches
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
                self._batches += 1
                self._queries += len(batch)
                self._size_hist[len(batch)] = \
                    self._size_hist.get(len(batch), 0) + 1
                self._bucket_hist[bucket] = \
                    self._bucket_hist.get(bucket, 0) + 1
                self._queue_wait_s += sum(now - p.t_enq for p in batch)
            t0 = time.monotonic()
            try:
                results = self._flush_fn([p.item for p in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"flush returned {len(results)} results for a "
                        f"batch of {len(batch)}")
                for p, r in zip(batch, results):
                    p.result = r
            except BaseException as e:  # every waiter gets the error
                for p in batch:
                    p.error = e
            with self._cond:
                self._flush_s += time.monotonic() - t0
            for p in batch:
                p.done.set()

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
        """The `GET /` batching block (the JAX package's key set)."""
        with self._cond:
            batches, queries = self._batches, self._queries
            return {
                "maxBatchSize": self.max_batch_size,
                "maxDelayMs": self.max_delay_s * 1e3,
                "maxQueue": self.max_queue,
                "buckets": list(self.buckets),
                "queueDepth": len(self._q),
                "batches": batches,
                "queries": queries,
                "rejected": self._rejected,
                "batchSizeHist": {str(k): v for k, v in
                                  sorted(self._size_hist.items())},
                "bucketHist": {str(k): v for k, v in
                               sorted(self._bucket_hist.items())},
                "avgQueueWaitMs": (self._queue_wait_s / queries * 1e3
                                   if queries else 0.0),
                "avgFlushMs": (self._flush_s / batches * 1e3
                               if batches else 0.0),
            }
