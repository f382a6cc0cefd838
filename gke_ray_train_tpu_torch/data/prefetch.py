"""Asynchronous input pipeline: background prefetch and placement on the
card (counterpart of ``gke_ray_train_tpu/data/prefetch.py``, the port's own
copy, and of the single-device case of
``gke_ray_train_tpu/parallel/placement.py::make_place_batch``).

Two things overlap when the host feeds the card: the card's compute
against host work (PyTorch queues kernels asynchronously, which gives the
loop about a step of lookahead while the host keeps up), and the host's
production of batch N+1..N+k against batch N. :class:`Prefetcher` runs
``place_fn`` on ``workers`` threads that pull from the iterator (under a
lock: a Python iterator admits no concurrent ``next``), and delivers **in
ticket order**, so the consumed stream is identical to the serial one.
GIL-releasing work (file reads, host-to-device copies, HF fast
tokenizers) parallelizes; work left inside the iterator only overlaps.

Backpressure: a worker may not start placing ticket T until
``T < consumed + depth``, bounding placed batches at ``depth`` (plus the
at most ``workers`` being placed).

Shared contract of :class:`Prefetcher` and :class:`SyncBatchSource`
(the ``depth=0`` inline path: one iteration shape in the loop):

- **resume fast-forward skip**: the first ``skip`` batches are consumed
  from the iterator but never placed (``place_fn`` not called).
- **wait accounting**: ``consume_wait()`` returns the host seconds the
  consumer spent blocked since the last call.
- **exception propagation**: an iterator or placement error re-raises at
  the consumer's ``next()`` (type preserved), after every batch that
  preceded it.
- **clean shutdown**: ``close()`` stops the workers and joins them;
  exhaustion drains and joins them itself.

Placement on the card (:func:`make_place_batch`): a worker copies the
numpy batch into pinned host tensors, then to the card with
``non_blocking=True`` on a side CUDA stream, and records an event. A
batch so placed (:class:`PlacedBatch`) is made ready on the consumer's
thread when a source delivers it: the consumer's current stream waits on
the event, and each tensor is marked used on that stream
(``record_stream``), so the caching allocator does not hand its memory to
a later batch while the step may still read it. A pinned buffer is not
reused before its copy ends: PyTorch's pinned-memory allocator records
the copy's stream and waits for it. Each worker sets the card as its
current device, since a thread starts on device 0.

Determinism: ticket-ordered delivery means a prefetched run consumes the
identical batch stream, so its losses are bitwise those of the inline
path.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from gke_ray_train_tpu_torch.device import DeviceLike, resolve_device


def _ready(item):
    """``item`` made ready for the consumer's thread: a
    :class:`PlacedBatch` waits for its copy there; anything else passes."""
    return item.wait() if isinstance(item, PlacedBatch) else item


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class SyncBatchSource:
    """The inline (no-thread) batch source: pull → skip-or-place → yield.

    Counters after iteration: ``yielded`` = batches pulled from the
    underlying iterator (skipped included), ``skipped`` = resume
    fast-forward batches consumed without placement.
    """

    def __init__(self, iterable: Iterable[Dict], *,
                 place_fn: Optional[Callable] = None, skip: int = 0):
        self._it = iter(iterable)
        self._place = place_fn
        self._skip = max(int(skip), 0)
        self.yielded = 0
        self.skipped = 0
        self._wait = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            while True:
                batch = next(self._it)
                self.yielded += 1
                if self.skipped < self._skip:
                    self.skipped += 1
                    continue
                if self._place is not None:
                    batch = self._place(batch)
                return _ready(batch)
        finally:
            self._wait += time.perf_counter() - t0

    def consume_wait(self) -> float:
        w, self._wait = self._wait, 0.0
        return w

    def close(self) -> None:
        pass


class Prefetcher:
    """Bounded multi-worker prefetch with on-thread device placement and
    deterministic (ticket-ordered) delivery."""

    def __init__(self, iterable: Iterable[Dict], *,
                 place_fn: Optional[Callable] = None, depth: int = 2,
                 skip: int = 0, workers: Optional[int] = None,
                 name: str = "batch-prefetch"):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it = iter(iterable)
        self._place = place_fn
        self._skip = max(int(skip), 0)
        self.yielded = 0
        self.skipped = 0
        self._wait = 0.0
        self.depth = depth
        # default: one placement worker per queue slot (backpressure
        # bounds useful concurrency at `depth` anyway), capped at 8 so a
        # deep queue does not spawn a thread horde; explicit `workers`
        # still clamps to depth — extra producers would only park
        self.workers = max(1, min(int(workers) if workers
                                  else min(depth, 8), depth))
        self._src_lock = threading.Lock()   # iterator pull + ticketing
        self._cond = threading.Condition()  # results / backpressure
        self._results: Dict[int, object] = {}
        self._next_ticket = 0   # next ticket a worker will take
        self._next_out = 0      # next ticket the consumer will deliver
        self._end_ticket: Optional[int] = None  # tickets == stream length
        self._exhausted = False
        self._stop = threading.Event()
        self._done = False
        self._threads = [
            threading.Thread(target=self._work, name=f"{name}-{i}",
                             daemon=True)
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    # -- worker side ---------------------------------------------------
    def _work(self) -> None:
        while not self._stop.is_set():
            # pull + ticket under one lock: tickets follow iterator order
            with self._src_lock:
                if self._exhausted:
                    return
                try:
                    batch = next(self._it)
                except StopIteration:
                    self._exhausted = True
                    self._finish(self._next_ticket)
                    return
                except BaseException as e:  # noqa: BLE001 - consumer raises
                    self._exhausted = True
                    ticket = self._next_ticket
                    self._next_ticket += 1
                    self._deliver(ticket, _Failure(e))
                    self._finish(ticket + 1)
                    return
                self.yielded += 1
                if self.skipped < self._skip:
                    # resume fast-forward: consumed, never transferred
                    self.skipped += 1
                    continue
                ticket = self._next_ticket
                self._next_ticket += 1
            # backpressure: at most `depth` placed-but-undelivered batches
            with self._cond:
                while not self._stop.is_set() and \
                        ticket >= self._next_out + self.depth:
                    self._cond.wait(0.05)
            if self._stop.is_set():
                return
            try:
                item = self._place(batch) if self._place is not None \
                    else batch
            except BaseException as e:  # noqa: BLE001 - consumer raises
                item = _Failure(e)
            self._deliver(ticket, item)

    def _deliver(self, ticket: int, item) -> None:
        with self._cond:
            self._results[ticket] = item
            self._cond.notify_all()

    def _finish(self, end_ticket: int) -> None:
        with self._cond:
            if self._end_ticket is None:
                self._end_ticket = end_ticket
            self._cond.notify_all()

    # -- consumer side -------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        item = None
        ended = dead = False
        try:
            with self._cond:
                while True:
                    if self._next_out in self._results:
                        item = self._results.pop(self._next_out)
                        self._next_out += 1
                        self._cond.notify_all()  # open the window
                        break
                    if self._end_ticket is not None and \
                            self._next_out >= self._end_ticket:
                        self._done = ended = True
                        break
                    if not any(t.is_alive() for t in self._threads):
                        self._done = dead = True
                        break
                    self._cond.wait(0.1)
        finally:
            self._wait += time.perf_counter() - t0
        # joins happen OUTSIDE the condition lock (a worker parked on it
        # could never exit otherwise)
        if ended:
            for t in self._threads:
                t.join(timeout=10.0)
            raise StopIteration
        if dead:
            raise RuntimeError("prefetch workers exited without a result "
                               "(killed thread?)")
        if isinstance(item, _Failure):
            self._done = True
            self.close()
            raise item.exc
        return _ready(item)

    def consume_wait(self) -> float:
        w, self._wait = self._wait, 0.0
        return w

    def close(self) -> None:
        """Stop the workers and reclaim the threads. Safe to call twice,
        and after normal exhaustion (then it is a no-op join)."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=10.0)
        self._done = True


def make_batch_source(iterable: Iterable[Dict], *,
                      place_fn: Optional[Callable] = None, depth: int = 0,
                      skip: int = 0, workers: Optional[int] = None):
    """``depth >= 1`` → background :class:`Prefetcher`; ``depth <= 0`` →
    inline :class:`SyncBatchSource`. One call site, one iteration shape."""
    if depth and depth > 0:
        return Prefetcher(iterable, place_fn=place_fn, depth=depth,
                          skip=skip, workers=workers)
    return SyncBatchSource(iterable, place_fn=place_fn, skip=skip)


class PlacedBatch(dict):
    """A batch of tensors on the card, copied on a side stream that
    ``event`` follows. ``wait()`` orders the calling thread's current
    stream after the copy and marks every tensor used on that stream;
    the batch sources call it when they deliver the batch."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 event: "torch.cuda.Event", device: torch.device):
        super().__init__(tensors)
        self._event = event
        self._device = device

    def wait(self) -> "PlacedBatch":
        if self._event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(self._event)
            for t in self.values():
                t.record_stream(stream)
            self._event = None
        return self


def make_place_batch(device: DeviceLike = None, *, mesh=None
                     ) -> Callable[[Dict[str, np.ndarray]],
                                   Dict[str, torch.Tensor]]:
    """The ``place_fn`` that puts a numpy batch on ``device`` (default
    ``cuda``, which must exist). On the card: pinned host tensors, then
    ``non_blocking`` copies on a side stream of that device, returned as
    a :class:`PlacedBatch` (the stream is made once, here). With
    ``device="cpu"``: CPU tensors holding a copy of each array, and no
    CUDA call. On a rank of a process group the batch is this rank's
    rows (``parallel/placement.py``) and ``device`` None is the rank's
    own card, ``cuda:LOCAL_RANK``. On a ``mesh`` whose ``context`` axis
    exceeds 1 (JAX's ``context_sharded`` placement) each batch is first
    cut to this context rank's ``S / C`` tokens of its token-aligned keys
    (``parallel/placement.py::context_slice``)."""
    from gke_ray_train_tpu_torch.parallel.mesh import context_size
    dev = resolve_device(device)
    if context_size(mesh) > 1:
        from gke_ray_train_tpu_torch.parallel.placement import (
            context_slice)
        inner = make_place_batch(dev)
        return lambda batch: inner(context_slice(batch, mesh))
    if dev.type == "cpu":
        def place_cpu(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
            return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        return place_cpu
    if dev.type != "cuda":
        raise ValueError(f"batches are placed on cuda or cpu, not {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(device=dev)

    def place(batch: Dict[str, np.ndarray]) -> PlacedBatch:
        # a worker thread starts on device 0: name the card
        with torch.cuda.device(dev), torch.cuda.stream(side):
            out = {}
            for k, v in batch.items():
                host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                out[k] = host.to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        return PlacedBatch(out, event, dev)
    return place
