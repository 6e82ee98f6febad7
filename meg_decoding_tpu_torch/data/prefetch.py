"""Host→device prefetch: the spill path for datasets that exceed the card's
memory.  Port of ``meg_decoding_tpu/data/prefetch.py``.

The packed datasets fit on the card whole by default, and a batch is a
gather on the device.  A dataset spilled to host memory (``to_host``) is
gathered on the host instead, and this module replaces the reference's
DataLoader worker processes (``utils/get_dataloaders.py:13,74``): a
background thread gathers the next batches and starts their copies to the
card while the current step runs.

On CUDA each batch is copied from pinned host memory with
``non_blocking=True`` on a side ``torch.cuda.Stream``, and an event is
recorded after the copy.  The consumer's stream waits on that event before
the step reads the batch, and each copied tensor is marked with
``record_stream`` for the consumer's stream: it was allocated on the side
stream, and without the mark the caching allocator could hand its memory
out again while the step still reads it.  The pinned source of a copy is
kept referenced until the copy's event has completed.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterable, Iterator

import torch

from meg_decoding_tpu_torch.device import resolve_device

__all__ = ["prefetch_to_device", "to_device"]

_SENTINEL = object()


def _map(batch, fn):
    """``fn`` on every tensor of a tuple/list/dict batch; other leaves as
    they are."""
    if torch.is_tensor(batch):
        return fn(batch)
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(b, fn) for b in batch)
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    return batch


def _tensors(batch) -> list:
    out = []
    _map(batch, out.append)
    return out


def to_device(batch, device: str | torch.device, non_blocking: bool = False):
    """Every tensor of ``batch`` on ``device``."""
    dev = torch.device(device)
    return _map(batch, lambda t: t.to(dev, non_blocking=non_blocking))


class _Staged:
    """A batch whose copy to the card was started on a side stream: the
    copies, the event recorded after them, and the host source."""

    def __init__(self, batch, event: torch.cuda.Event, source,
                 device: torch.device):
        self.batch, self.event, self.source = batch, event, source
        self.device = device


def _side_stream_put(dev: torch.device) -> Callable:
    side = torch.cuda.Stream(dev)

    def put(batch) -> _Staged:
        with torch.cuda.device(dev), torch.cuda.stream(side):
            out = to_device(batch, dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        return _Staged(out, event, batch, dev)

    return put


def prefetch_to_device(batches: Iterable, size: int = 2,
                       device_put: Callable | None = None,
                       device: str | torch.device = "cuda") -> Iterator:
    """Iterate ``batches``, staying ``size`` device transfers ahead.

    ``batches`` yields tuples (lists, dicts) of host tensors, e.g. a
    generator calling a host-side gather.  Each is moved to ``device`` on a
    worker thread: on CUDA by a copy on a side stream (module docstring),
    on the CPU by nothing (the identity), or by ``device_put(batch)`` when
    given.

    Exceptions in the producer are raised at the consumer, at the point of
    iteration.  Abandoning the iterator (an error or ``break`` in the
    consumer) stops the worker: it would otherwise block on the full queue
    for the rest of the process, holding ``size`` batches.  The worker is a
    daemon thread, so interpreter shutdown never waits on it."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    if device_put is None:
        dev = resolve_device(device)
        device_put = (_side_stream_put(dev) if dev.type == "cuda"
                      else (lambda batch: batch))
    return _prefetch(batches, size, device_put)


def _prefetch(batches: Iterable, size: int, device_put: Callable) -> Iterator:
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def _put(item) -> bool:
        """Queue put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in batches:
                if not _put(device_put(batch)):
                    return
        except BaseException as e:  # raised at the consumer below
            _put((_SENTINEL, e))
            return
        _put((_SENTINEL, None))

    threading.Thread(target=worker, daemon=True).start()
    in_flight = collections.deque()  # (event, host source) of started copies
    try:
        while True:
            item = q.get()
            if (isinstance(item, tuple) and len(item) == 2
                    and item[0] is _SENTINEL):
                if item[1] is not None:
                    raise item[1]
                return
            if isinstance(item, _Staged):
                consumer = torch.cuda.current_stream(item.device)
                consumer.wait_event(item.event)
                for t in _tensors(item.batch):
                    t.record_stream(consumer)
                in_flight.append((item.event, item.source))
                while in_flight and in_flight[0][0].query():
                    in_flight.popleft()
                item = item.batch
            yield item
    finally:
        stop.set()
        while not q.empty():  # release buffered batches promptly
            try:
                q.get_nowait()
            except queue.Empty:
                break
        for event, _ in in_flight:
            event.synchronize()
