"""The port's TensorBoard scalar reader (``utils/tb_reader.py``) against the
JAX package's, exactly, on event files written by either package's writer:
scalars of several tags, image summaries among them (skipped structurally),
a restarted run's second file, and a truncated tail."""

import os

import numpy as np
import pytest

from selectivenet_for_semantic_segmentation_binary_tpu.utils import tb_reader as jax_reader
from selectivenet_for_semantic_segmentation_binary_tpu.utils import tb_writer as jax_writer
from selectivenet_for_semantic_segmentation_binary_torch.utils import tb_reader
from selectivenet_for_semantic_segmentation_binary_torch.utils import tb_writer as port_writer

WRITERS = {"jax": jax_writer, "port": port_writer}


def _write_run(writer_mod, log_dir, seed, epochs=(1, 2, 3)):
    rng = np.random.default_rng(seed)
    w = writer_mod.SummaryWriter(log_dir)
    for epoch in epochs:
        w.add_scalar("loss", float(rng.random()), epoch)
        w.add_scalar("selection loss", float(rng.random()), epoch)
        w.add_images("pred", (rng.random((2, 8, 8, 1)) * 255).astype(np.uint8), epoch)
        w.add_scalar("lr", 1e-3 / epoch, epoch)
    w.close()


@pytest.mark.parametrize("writer", list(WRITERS))
def test_read_scalars_equals_jax(writer, tmp_path):
    log_dir = str(tmp_path / "log")
    _write_run(WRITERS[writer], log_dir, seed=1)
    (first,) = os.listdir(log_dir)  # an older run's file: sorted first
    os.rename(os.path.join(log_dir, first), os.path.join(log_dir, "events.out.tfevents.1.old"))
    _write_run(WRITERS[writer], log_dir, seed=2, epochs=(4, 5))  # a restarted run
    assert len(os.listdir(log_dir)) == 2
    got, want = tb_reader.read_scalars(log_dir), jax_reader.read_scalars(log_dir)
    assert got == want
    assert sorted(got) == ["loss", "lr", "selection loss"]
    assert [s for s, _ in got["loss"]] == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("writer", list(WRITERS))
def test_truncated_tail_stops_cleanly(writer, tmp_path):
    log_dir = str(tmp_path / "log")
    _write_run(WRITERS[writer], log_dir, seed=3)
    (path,) = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-7])  # the writer died mid-record
    got, want = tb_reader.read_scalars(log_dir), jax_reader.read_scalars(log_dir)
    assert got == want and len(got["loss"]) == 3 and len(got["lr"]) == 2


def test_varint_and_fields_equal_jax():
    buf = bytes([0x08, 0x96, 0x01, 0x11]) + bytes(8) + bytes([0x1a, 0x03]) + b"abc" \
        + bytes([0x25]) + bytes(4)
    assert list(tb_reader._fields(buf)) == list(jax_reader._fields(buf))
    assert tb_reader._read_varint(bytes([0xac, 0x02]), 0) == (300, 2)
    with pytest.raises(ValueError, match="wire type"):
        list(tb_reader._fields(bytes([0x0b])))
