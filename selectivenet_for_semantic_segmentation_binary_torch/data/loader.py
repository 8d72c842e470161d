"""Threaded host-to-device batch feed of decoded patches.

Counterpart of the JAX package's ``data/loader.py:32-288``, in its two
modes:

* **raw** (``device_preproc=True``, the default): inputs are (N, H, W, 3)
  uint8 from the dataset's ``get_raw``, normalised (and flipped) on the
  device by ``train_lib.device_preprocess``, so the copy carries a quarter
  of the float32 bytes; with ``random_flip`` sample ``i`` carries the flip
  bits (left-right, up-down) ``default_rng([seed, epoch, i]).random(2) >
  0.5``;
* **float** (``device_preproc=False``): the host does the colour math.
  Sample ``i`` is ``dataset.__getitem__(i, rng=default_rng([seed, epoch,
  i]))`` (stain conversion and the dataset's transform, flips included),
  and inputs are (N, H, W, C) float32 with C the dataset's channels (2 for
  GH, as the JAX ``_sample_shape`` has it); no ``"flips"`` key. Only this
  mode serves GH and H_RGB inputs, blank-field correction and PNT.

In both modes:

* static shapes: every batch holds exactly ``batch_size`` samples; with
  ``drop_last`` the final partial batch is dropped, otherwise it is padded
  with zero inputs and ``PAD_LABEL`` labels, which drop out of every count
  and every loss; labels are (N, H, W) uint8;
* with ``shuffle`` the epoch's order is ``default_rng([seed, epoch])``'s
  permutation;
* a decode thread (with a pool of ``num_workers`` threads inside) assembles
  batches ahead into pinned host memory; each batch is copied with
  ``non_blocking`` on a side stream, and the consumer's stream waits on that
  copy only, so the copy of batch i+1 overlaps the compute of batch i;
* on a fleet (``process_index``/``process_count``, JAX ``data/loader.py:
  46-79, 141-160``) ``batch_size`` stays the GLOBAL batch: every rank walks
  the same order and decodes only its contiguous ``batch_size //
  process_count`` rows of each padded global batch, and ``nvalid`` stays
  the global count of real samples. A rank whose rows are all padding
  decodes nothing (the sample shape comes from the dataset's
  ``patch_size`` and ``input_type``) and still yields its padded rows;
* with ``--sp_ways`` (``spatial_index``/``spatial_count``; the ranks of a
  data-parallel group share its examples, ``process_index`` the group's
  index and ``process_count`` the group count) a rank keeps only its block
  of image rows, [s*h, (s+1)*h) of the H rows with h = H // spatial_count.
  JAX refuses an sp group that spans processes, because its loader slices
  no rows; here each rank is a process, so this loader slices them. The
  raw feed's up-down flip runs on the device after the slice: a sample
  whose up-down bit is set hands the rank the mirrored block [H - (s+1)*h,
  H - s*h), which the device's flip turns into rows [s*h, (s+1)*h) of the
  flipped image. The flip bits and ``nvalid`` are per example, the same on
  every rank of a group;
* traced (``utils/tracing.py``): on the decode thread ``loader.assemble``
  (one batch) and ``loader.put_blocked`` (the queue full: the feed is
  ahead), on the consumer ``loader.fill`` (an epoch's start to its first
  batch handed over), ``loader.wait`` (blocked on the queue) and
  ``loader.copy`` (the copy enqueued), keyed by (epoch, index).
"""

from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops.confusion import PAD_LABEL
from ..utils import tracing

_SENTINEL = object()
PREFETCH = 2  # batches decoded ahead of the consumer


class PatchLoader:
    """Iterable batch loader over a ``PatchDataset`` (or any dataset with
    ``__len__`` and, in raw mode, ``get_raw(i)`` returning (input (H, W, 3)
    uint8, label (H, W) uint8), in float mode ``__getitem__(i, rng)``
    returning ``{"input" (H, W, C) float32, "label" (H, W)}``).

    Yields ``{"input", "label", "nvalid"}`` and, with ``random_flip``,
    ``"flips"`` ((N, 2) uint8, zero on padding): the tensors on ``device``,
    ``nvalid`` the number of real (unpadded) samples in the global batch."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 8,
                 device="cpu", shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, random_flip: bool = False, device_preproc: bool = True,
                 process_index: int = 0, process_count: int = 1, spatial_index: int = 0,
                 spatial_count: int = 1):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if batch_size % max(1, process_count) != 0:
            raise ValueError("batch_size must be divisible by process_count")
        if device_preproc and not hasattr(dataset, "get_raw"):
            raise ValueError("device_preproc requires a dataset with get_raw()")
        if random_flip and not device_preproc:
            raise ValueError("random_flip draws the device's flip bits (raw mode); the "
                             "float mode flips on the host (transforms.RandomFlip)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.random_flip = random_flip
        self.device_preproc = device_preproc
        self.process_index = process_index
        self.process_count = max(1, process_count)
        self.spatial_index = spatial_index
        self.spatial_count = max(1, spatial_count)
        self._shape = None  # (H, W, C) of one input, once known
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

    def _rng(self, epoch: int, index: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, epoch, index])

    def _flips(self, epoch: int, index: int) -> np.ndarray:
        return (self._rng(epoch, index).random(2) > 0.5).astype(np.uint8)

    def _sample(self, epoch: int, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """One sample's (input, label) as this mode decodes it."""
        if self.device_preproc:
            return self.dataset.get_raw(index)
        data = self.dataset.__getitem__(index, rng=self._rng(epoch, index))
        return data["input"], data["label"]

    def _sample_shape(self) -> Tuple[int, int, int]:
        """(H, W, C) of one input without a decode where the dataset says it
        (JAX ``_sample_shape``): raw batches are RGB, the float feed has 2
        channels for GH."""
        if self._shape is None:
            ds = self.dataset
            if hasattr(ds, "patch_size") and hasattr(ds, "input_type"):
                c = 2 if (not self.device_preproc and ds.input_type == "GH") else 3
                self._shape = (ds.patch_size, ds.patch_size, c)
            else:
                self._shape = tuple(self._sample(0, 0)[0].shape)
        return self._shape

    def _assemble(self, pool: ThreadPoolExecutor, indices: np.ndarray, epoch: int) -> dict:
        nvalid = len(indices)  # real samples of the global batch
        rows = self.batch_size // self.process_count
        lo = self.process_index * rows
        indices = indices[lo:lo + rows]  # this rank's slice (all of it for one process)
        samples = list(pool.map(lambda i: self._sample(epoch, int(i)), indices))
        if samples:
            self._shape = tuple(samples[0][0].shape)
        h, w, c = self._sample_shape()
        if h % self.spatial_count:
            raise ValueError(f"the image's {h} rows do not split into "
                             f"{self.spatial_count} row blocks")
        h //= self.spatial_count
        bits = [self._flips(epoch, int(i)) for i in indices] if self.random_flip else None
        if self.spatial_count > 1:
            lo = self.spatial_index * h
            hi = [h * self.spatial_count - lo if bits is not None and bits[k][1] else lo + h
                  for k in range(len(samples))]
            samples = [(x[e - h:e], y[e - h:e]) for (x, y), e in zip(samples, hi)]
        pin = self.device.type == "cuda"
        inp = torch.zeros((rows, h, w, c),
                          dtype=torch.uint8 if self.device_preproc else torch.float32,
                          pin_memory=pin)
        lab = torch.full((rows, h, w), PAD_LABEL, dtype=torch.uint8, pin_memory=pin)
        inp_np, lab_np = inp.numpy(), lab.numpy()
        for row, (x, y) in enumerate(samples):
            inp_np[row] = x
            lab_np[row] = y  # {0, 1} from any integer dtype
        batch = {"input": inp, "label": lab, "nvalid": nvalid}
        if self.random_flip:
            flips = torch.zeros((rows, 2), dtype=torch.uint8, pin_memory=pin)
            flips.numpy()[:len(indices)] = bits
            batch["flips"] = flips
        return batch

    def _decode_ahead(self, out_q: queue.Queue, stop: threading.Event,
                      epoch: int) -> None:
        def put(item) -> bool:
            try:
                out_q.put_nowait(item)
                return True
            except queue.Full:
                pass
            with tracing.span("loader.put_blocked", key):  # the feed is ahead
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
        key = (epoch, -1)
        try:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for b in range(len(self)):
                    key = (epoch, b)
                    indices = order[b * self.batch_size:(b + 1) * self.batch_size]
                    with tracing.span("loader.assemble", key):
                        batch = self._assemble(pool, indices, epoch)
                    if not put(batch):
                        return
            key = (epoch, len(self))
            put(_SENTINEL)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    def _host_batches(self) -> Iterator[Tuple[tuple, dict]]:
        """(key, host batch) in order, from a decode thread of this epoch;
        key is (epoch, index), and the wait for each is ``loader.wait``."""
        epoch = self._epoch
        out_q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        thread = threading.Thread(target=self._decode_ahead,
                                  args=(out_q, stop, epoch), daemon=True)
        thread.start()
        try:
            for index in itertools.count():
                with tracing.span("loader.wait", (epoch, index)):
                    item = out_q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield (epoch, index), item
        finally:
            stop.set()
            thread.join(timeout=10)

    def __iter__(self) -> Iterator[dict]:
        """One epoch's batches; from here to the first handed over is
        ``loader.fill``."""
        fill = tracing.span("loader.fill", self._epoch)
        fill.__enter__()
        try:
            for batch in self._device_batches():
                if fill is not None:
                    fill.__exit__(None, None, None)
                    fill = None
                yield batch
        finally:
            if fill is not None:
                fill.__exit__(None, None, None)

    def _device_batches(self) -> Iterator[dict]:
        if self.device.type != "cuda":
            for key, host in self._host_batches():
                with tracing.span("loader.copy", key):
                    batch = {k: v.to(self.device) if torch.is_tensor(v) else v
                             for k, v in host.items()}
                yield batch
            return

        copy_stream = torch.cuda.Stream(device=self.device)
        pending: Optional[dict] = None
        for key, host in self._host_batches():
            with tracing.span("loader.copy", key), torch.cuda.stream(copy_stream):
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
