"""Batch prefetch to the card: host assembly and the host-to-device copy
overlap the train step.

The counterpart of ``speaker3d_tpu/data/prefetch.py``. A background thread
pulls numpy batches from the loader, writes each into a pinned host buffer
and copies it to the card on a side stream, recording an event after the
copy; the consumer's stream waits on that event (on the card, not the host)
before the step reads the batch. Two hazards and what guards them:

- a pinned buffer is reused only after its copy has finished: the buffers
  form a ring, and the thread waits on the event of a buffer's last copy
  before it writes into the buffer again;
- the device tensors were allocated on the side stream but are read on the
  consumer's: ``record_stream`` keeps the caching allocator from handing
  their memory out again before the consumer's work on them is done.

On the CPU the batches pass through as tensors that share the numpy
arrays' memory.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

from speaker3d_tpu_torch.device import DEFAULT_DEVICE, resolve_device


class _PinnedRing:
    """``slots`` sets of pinned host buffers, one per batch key, each set
    with the event of its last copy to the card."""

    def __init__(self, slots: int):
        self.bufs = [dict() for _ in range(slots)]
        self.events = [None] * slots
        self.next = 0

    def stage(self, batch: Dict[str, np.ndarray], device, stream):
        i = self.next
        self.next = (i + 1) % len(self.bufs)
        if self.events[i] is not None:
            self.events[i].synchronize()  # the buffer's last copy is done
        out = {}
        with torch.cuda.stream(stream):
            for key, arr in batch.items():
                src = torch.from_numpy(np.ascontiguousarray(arr))
                buf = self.bufs[i].get(key)
                if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                    buf = torch.empty(src.shape, dtype=src.dtype,
                                      pin_memory=True)
                    self.bufs[i][key] = buf
                buf.copy_(src)
                out[key] = buf.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        self.events[i] = event
        return out, event


def device_prefetch(iterator: Iterable, device=DEFAULT_DEVICE,
                    depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches of ``iterator`` (dicts of numpy arrays) as dicts of
    tensors on ``device``, up to ``depth`` batches ahead on a background
    thread. The loader's exceptions reach the consumer; closing the
    generator stops the thread."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        for batch in iterator:
            yield {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        return

    stream = torch.cuda.Stream(device=dev)
    # depth queued + one the consumer holds + one being staged
    ring = _PinnedRing(depth + 2)
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    end = object()
    error: list = [None]

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in iterator:
                if not _put(ring.stage(batch, dev, stream)):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            error[0] = e
        _put(end)

    thread = threading.Thread(target=worker, daemon=True,
                              name="device_prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if error[0] is not None:
                    raise error[0]
                return
            batch, event = item
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(event)
            for t in batch.values():
                t.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        thread.join(timeout=5.0)
