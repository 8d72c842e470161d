"""Threaded host-to-device batch feed of raw uint8 patches.

Counterpart of the JAX package's ``data/loader.py:32-288`` in raw mode
(``device_preproc``), the training and evaluation feed:

* static shapes: every batch holds exactly ``batch_size`` samples; with
  ``drop_last`` the final partial batch is dropped, otherwise it is padded
  with zero pixels and ``PAD_LABEL`` labels, which drop out of every count
  and every loss;
* deterministic order and augmentation, as in the JAX package: with
  ``shuffle`` the epoch's order is ``default_rng([seed, epoch])``'s
  permutation, and with ``random_flip`` sample ``i`` carries the flip bits
  (left-right, up-down) ``default_rng([seed, epoch, i]).random(2) > 0.5``,
  applied on the device (``train_lib.device_preprocess``);
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

import numpy as np
import torch

from ..ops.confusion import PAD_LABEL

_SENTINEL = object()
PREFETCH = 2  # batches decoded ahead of the consumer


class PatchLoader:
    """Iterable batch loader over any dataset with ``get_raw(i)`` returning
    (input (H, W, 3) uint8, label (H, W) uint8) and ``__len__``.

    Yields ``{"input", "label", "nvalid"}`` and, with ``random_flip``,
    ``"flips"`` ((N, 2) uint8, zero on padding): the tensors on ``device``,
    ``nvalid`` the number of real (unpadded) samples in the batch."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 device="cpu", shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, random_flip: bool = False):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.random_flip = random_flip
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng([self.seed, epoch]).shuffle(idx)
        return idx

    def _flips(self, epoch: int, index: int) -> np.ndarray:
        return (np.random.default_rng([self.seed, epoch, index]).random(2) > 0.5).astype(np.uint8)

    def _assemble(self, pool: ThreadPoolExecutor, indices: np.ndarray, epoch: int) -> dict:
        samples = list(pool.map(self.dataset.get_raw, (int(i) for i in indices)))
        h, w, c = samples[0][0].shape
        pin = self.device.type == "cuda"
        inp = torch.zeros((self.batch_size, h, w, c), dtype=torch.uint8, pin_memory=pin)
        lab = torch.full((self.batch_size, h, w), PAD_LABEL, dtype=torch.uint8,
                         pin_memory=pin)
        inp_np, lab_np = inp.numpy(), lab.numpy()
        for row, (x, y) in enumerate(samples):
            inp_np[row] = x
            lab_np[row] = y
        batch = {"input": inp, "label": lab, "nvalid": len(samples)}
        if self.random_flip:
            flips = torch.zeros((self.batch_size, 2), dtype=torch.uint8, pin_memory=pin)
            flips.numpy()[:len(indices)] = [self._flips(epoch, int(i)) for i in indices]
            batch["flips"] = flips
        return batch

    def _decode_ahead(self, out_q: queue.Queue, stop: threading.Event,
                      epoch: int) -> None:
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

        order = self._order(epoch)
        try:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for b in range(len(self)):
                    indices = order[b * self.batch_size:(b + 1) * self.batch_size]
                    if not put(self._assemble(pool, indices, epoch)):
                        return
            put(_SENTINEL)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    def _host_batches(self) -> Iterator[dict]:
        out_q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        thread = threading.Thread(target=self._decode_ahead,
                                  args=(out_q, stop, self._epoch), daemon=True)
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
                yield {k: v.to(self.device) if torch.is_tensor(v) else v
                       for k, v in host.items()}
            return

        copy_stream = torch.cuda.Stream(device=self.device)
        pending: Optional[dict] = None
        for host in self._host_batches():
            with torch.cuda.stream(copy_stream):
                batch = {k: v.to(self.device, non_blocking=True) if torch.is_tensor(v) else v
                         for k, v in host.items()}
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
        for v in batch.values():
            if torch.is_tensor(v):
                v.record_stream(consumer)
        return batch
