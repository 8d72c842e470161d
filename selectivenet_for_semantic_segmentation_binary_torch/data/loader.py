"""Threaded host-to-device batch feed of raw uint8 patches.

Counterpart of the JAX package's ``data/loader.py:32-288`` in raw mode
(``device_preproc``) without shuffling, the evaluation feed:

* static shapes: every batch holds exactly ``batch_size`` samples; the final
  partial batch is padded with zero pixels and ``PAD_LABEL`` labels, which
  drop out of every count;
* inputs are (N, H, W, 3) uint8 and labels (N, H, W) uint8, normalised on
  the device, so the copy carries a quarter of the float32 bytes;
* a decode thread (with a pool of ``num_workers`` threads inside) assembles
  batches ahead into pinned host memory; each batch is copied with
  ``non_blocking`` on a side stream, and the consumer's stream waits on that
  copy only, so the copy of batch i+1 overlaps the compute of batch i.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import torch

from ..ops.confusion import PAD_LABEL

_SENTINEL = object()
PREFETCH = 2  # batches decoded ahead of the consumer


class PatchLoader:
    """Iterable batch loader over any dataset with ``get_raw(i)`` returning
    (input (H, W, 3) uint8, label (H, W) uint8) and ``__len__``.

    Yields ``{"input", "label", "nvalid"}``: the two tensors on ``device``,
    ``nvalid`` the number of real (unpadded) samples in the batch."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 device="cpu"):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.device = torch.device(device)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _assemble(self, pool: ThreadPoolExecutor, indices: range) -> dict:
        samples = list(pool.map(self.dataset.get_raw, indices))
        h, w, c = samples[0][0].shape
        pin = self.device.type == "cuda"
        inp = torch.zeros((self.batch_size, h, w, c), dtype=torch.uint8, pin_memory=pin)
        lab = torch.full((self.batch_size, h, w), PAD_LABEL, dtype=torch.uint8,
                         pin_memory=pin)
        inp_np, lab_np = inp.numpy(), lab.numpy()
        for row, (x, y) in enumerate(samples):
            inp_np[row] = x
            lab_np[row] = y
        return {"input": inp, "label": lab, "nvalid": len(samples)}

    def _decode_ahead(self, out_q: queue.Queue, stop: threading.Event) -> None:
        def put(item) -> bool:
            # re-check stop: a consumer that abandons iteration must not
            # strand this thread on a full queue
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        n = len(self.dataset)
        try:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for start in range(0, n, self.batch_size):
                    batch = self._assemble(pool, range(start, min(start + self.batch_size, n)))
                    if not put(batch):
                        return
            put(_SENTINEL)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    def _host_batches(self) -> Iterator[dict]:
        out_q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        thread = threading.Thread(target=self._decode_ahead, args=(out_q, stop),
                                  daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=10)

    def __iter__(self) -> Iterator[dict]:
        if self.device.type != "cuda":
            for host in self._host_batches():
                yield {"input": host["input"].to(self.device),
                       "label": host["label"].to(self.device),
                       "nvalid": host["nvalid"]}
            return

        copy_stream = torch.cuda.Stream(device=self.device)
        pending: Optional[dict] = None
        for host in self._host_batches():
            with torch.cuda.stream(copy_stream):
                batch = {k: host[k].to(self.device, non_blocking=True)
                         for k in ("input", "label")}
                batch["nvalid"] = host["nvalid"]
                batch["_copied"] = torch.cuda.Event()
                batch["_copied"].record(copy_stream)
            if pending is not None:
                yield self._ready(pending)
            pending = batch
        if pending is not None:
            yield self._ready(pending)

    def _ready(self, batch: dict) -> dict:
        """Make the consumer's stream wait for this batch's copy, and tell the
        caching allocator the tensors are used there."""
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(batch.pop("_copied"))
        batch["input"].record_stream(consumer)
        batch["label"].record_stream(consumer)
        return batch
