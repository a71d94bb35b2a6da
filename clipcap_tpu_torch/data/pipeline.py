"""Host -> device input pipeline: background staging and double buffering
(the port's own copy of clipcap_tpu/data/pipeline.py).

The reference leans on torch DataLoader worker processes (train.py:266) to
hide input latency. Here a daemon thread runs the (possibly C++-backed)
batch iterator and copies each batch to the device ahead of time, so the
card's next batch is already in its memory while the current step runs:
double buffering (queue depth 2 by default).

On CUDA the default transfer stages each array in pinned host memory and
copies it with `non_blocking=True` on a side stream, then records an
event there. Before the consumer sees a batch, its current stream waits
on that event, and each tensor is marked as used by that stream, so no
kernel reads a batch whose copy has not finished and the caching
allocator does not hand its memory back to the side stream while the
consumer may still read it.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

_SENTINEL = object()


class _Failed:
    """The worker's exception, handed to the consumer to raise."""

    def __init__(self, err: BaseException):
        self.err = err


def _map_tensors(fn, item):
    """fn over every array or tensor in a nested dict / list / tuple batch."""
    if isinstance(item, dict):
        return {k: _map_tensors(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_map_tensors(fn, v) for v in item)
    if isinstance(item, (np.ndarray, torch.Tensor)):
        return fn(item)
    return item


def _tensors(item) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map_tensors(lambda t: out.append(t) or t, item)
    return out


def to_device(item, device) -> Any:
    """Every array or tensor of a batch on `device`: pinned, non-blocking
    copies on CUDA (the caller orders them against its stream), plain
    copies elsewhere."""
    device = torch.device(device)

    def move(x):
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return _map_tensors(move, item)


def device_prefetch(
    iterator: Iterable,
    size: int = 2,
    transfer: Optional[Callable[[Any], Any]] = None,
    device="cuda",
) -> Iterator:
    """Wrap a host batch iterator with background device transfer.

    transfer: batch -> device batch (default: `to_device(batch, device)`,
    on a side stream when `device` is CUDA). An exception in the iterator
    or the transfer is raised to the consumer after the batches before it.
    """
    device = torch.device(device)
    stream = None
    if transfer is None:
        if device.type == "cuda":
            stream = torch.cuda.Stream(device)
        transfer = lambda item: to_device(item, device)  # noqa: E731
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def worker():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                if stream is None:
                    q.put((transfer(item), None))
                    continue
                with torch.cuda.stream(stream):
                    moved = transfer(item)
                    ready = torch.cuda.Event()
                    ready.record(stream)
                q.put((moved, ready))
        except BaseException as err:  # handed to the consumer, which raises it
            q.put(_Failed(err))
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    try:
        while True:
            got = q.get()
            if got is _SENTINEL:
                return
            if isinstance(got, _Failed):
                raise got.err
            item, ready = got
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for tensor in _tensors(item):
                    if tensor.is_cuda:
                        tensor.record_stream(consumer)
            yield item
    finally:
        stop.set()
        # drain so the worker can exit if blocked on put
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
