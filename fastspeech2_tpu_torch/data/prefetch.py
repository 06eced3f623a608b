"""Background prefetching for the input pipeline
(``fastspeech2_tpu/data/prefetch.py``), plus the copy to the device.

A bounded-queue background thread loads and pads batches (numpy and file IO
release the GIL) and, through ``transform``, moves each one to the device
while the step before it runs; the batcher's deterministic order is kept.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, TypeVar

import numpy as np
import torch

T = TypeVar("T")

_SENTINEL = object()


def batch_to_device(batch, device: torch.device):
    """A batch (NamedTuple) of numpy arrays -> the same NamedTuple of tensors
    on ``device``. On a CUDA device the arrays go through pinned memory on a
    copy stream of their own, which is waited for here, on the calling
    (producer) thread: the consumer gets finished tensors and the training
    stream never waits for a copy."""
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
    if device.type == "cuda":
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            tensors = [t.pin_memory().to(device, non_blocking=True) for t in tensors]
        stream.synchronize()
        for t in tensors:  # the training stream reads what this one allocated
            t.record_stream(torch.cuda.default_stream(device))
    return type(batch)(*tensors)


def prefetch(iterable: Iterable[T], depth: int = 2,
             transform: Optional[Callable[[T], T]] = None) -> Iterator[T]:
    """Iterate ``iterable`` on a background thread, ``depth`` items ahead,
    applying ``transform`` to each item there.

    Exceptions from the producer re-raise at the consumer's next pull;
    abandoning the iterator (break / GC) stops the producer promptly because
    puts block on the bounded queue and check the stop flag, and waits for
    it: a producer thread still inside a torch or numpy call when the
    interpreter exits is ended by the runtime inside C++ frames, which
    aborts the process ("terminate called without an active exception").
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: list[BaseException] = []

    def producer():
        try:
            for item in iterable:
                if transform is not None:
                    item = transform(item)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        # at most the item in hand: every put checks the flag within 0.1 s
        t.join()
