"""The port's recorder (``utils/profiling.py``: ``span``, ``count``,
``record``, ``reset``) and the spans and counters the port opens with it,
on the CPU:

- with no profiler running, a ``predict`` and two ``Trainer`` steps record
  nothing, and ``span`` / ``count`` return the shared no-op;
- under ``utils.profiling.trace``: a bucketed ``predict`` records each
  ``serving.*`` leaf once per forward batch and counts its pixels; a
  tiled ``predict`` records the tile and blend spans of each tile batch;
  ``decode_crop`` on a ``zlib_band`` pack counts the band rows it
  inflates, natively and on the Python fallback, and the C batch decode
  the whole records; two ``Trainer`` steps record their fetch, step and
  ``train_step.*`` spans with parents and units, and their decodes on
  the loader's threads; a decode-ahead loader counts the items it hands
  over and those already loaded, and opens a ``loader.wait`` span for
  each it waits for; the spans sit in the Chrome trace around the
  operators they launched;
- outputs and trained parameters are bit-identical with recording on
  and off.
"""

import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from lowlight_image_enhancement_tpu_torch.data import native_loader, records
from lowlight_image_enhancement_tpu_torch.data.debug_fixtures import (
    make_debug_sid,
)
from lowlight_image_enhancement_tpu_torch.models.nafnet import NAFNet
from lowlight_image_enhancement_tpu_torch.serving import RestorationServer
from lowlight_image_enhancement_tpu_torch.training.config import parse
from lowlight_image_enhancement_tpu_torch.training.trainer import Trainer
from lowlight_image_enhancement_tpu_torch.utils import profiling

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "debug",
                      "sid_newbp_mono_debug.yml")
SERVE = dict(bucket_step=64, min_bucket=64, max_bucket=64, max_batch=8,
             tile_overlap=0.5)
SERVING_LEAVES = ("serving.pad", "serving.h2d", "serving.forward",
                  "serving.wait", "serving.d2h", "serving.gather")
STEP_SPANS = ("train_step.forward", "train_step.backward",
              "train_step.optimizer")


@pytest.fixture(scope="module")
def server():
    torch.manual_seed(0)
    net = NAFNet(img_channel=3, width=8, enc_blk_nums=(1,), middle_blk_num=1,
                 dec_blk_nums=(1,))
    return RestorationServer(net, device="cpu", **SERVE)


def _images(shape, n):
    rng = np.random.default_rng(3)
    return [rng.uniform(0, 1, shape + (3,)).astype(np.float32)
            for _ in range(n)]


def _names(rec):
    return [s.name for s in rec["spans"]]


def _traced(tmp_path, fn):
    """``fn()`` under ``utils.profiling.trace``; its result, the record
    and the exported trace's events."""
    with profiling.trace(str(tmp_path)):
        out = fn()
    (path,) = glob.glob(os.path.join(str(tmp_path), "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return out, profiling.record(), events


@pytest.fixture(scope="module")
def debug_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("debug_sid"))
    make_debug_sid(root)
    return root


def _trainer(debug_root, tmp_path, monkeypatch, iters=2):
    monkeypatch.setenv("DEBUG_SID_ROOT", debug_root)
    opt = parse(CONFIG, is_train=True, root_dir=str(tmp_path))
    opt["train"]["total_iter"] = iters
    opt.pop("val", None)
    opt["path"] = {}
    return Trainer(opt, device="cpu")


def _params(trainer):
    return [p.detach().clone() for p in trainer.net.parameters()]


def test_off_records_nothing_and_returns_the_shared_no_op(
        server, debug_root, tmp_path, monkeypatch):
    profiling.reset()
    assert not profiling.recording()
    assert profiling.span("a") is profiling.span("b", unit=3)
    with profiling.span("a") as inside:
        assert inside is None
    assert profiling.count("c", 5) is None
    server.predict(_images((43, 64), 3))
    _trainer(debug_root, tmp_path, monkeypatch).train()
    assert profiling.record() == {"spans": [], "counters": {}}


def test_bucketed_predict_spans_and_pixel_counts(server, tmp_path):
    imgs = _images((43, 64), 3)
    off = server.predict(imgs)
    on, rec, _ = _traced(tmp_path, lambda: server.predict(imgs))
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    names = _names(rec)
    assert names.count("serving.predict") == 1
    for leaf in SERVING_LEAVES:         # one forward batch of 3
        assert names.count(leaf) == 1, leaf
    assert rec["counters"] == {"serving.px_in": 3 * 43 * 64,
                               "serving.px_run": 3 * 64 * 64}
    top = [s for s in rec["spans"] if s.name == "serving.predict"][0]
    assert top.parent is None and top.unit == server.calls
    for s in rec["spans"]:
        if s.name != "serving.predict":
            assert s.parent == "serving.predict" and s.unit == top.unit
            assert top.t0 <= s.t0 <= s.t1 <= top.t1


def test_tiled_predict_spans_and_pixel_counts(server, tmp_path):
    """150x200 at max_bucket 64: tiles at rows 0, 32, 64, 86 and columns
    0, 32, ..., 136, 24 tiles in 3 batches of 8."""
    imgs = _images((150, 200), 1)
    off = server.predict(imgs)
    on, rec, _ = _traced(tmp_path, lambda: server.predict(imgs))
    np.testing.assert_array_equal(off[0], on[0])
    names = _names(rec)
    assert names.count("validation.tiles") == 3
    assert names.count("validation.blend") == 3 + 1
    for leaf in SERVING_LEAVES[1:]:
        assert names.count(leaf) == 3, leaf
    assert "serving.pad" not in names
    assert rec["counters"] == {"serving.px_in": 150 * 200,
                               "serving.px_run": 24 * 64 * 64}
    assert {s.parent for s in rec["spans"]} == {None, "serving.predict"}


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("top,ph,rows", [(70, 32, 64), (100, 40, 128),
                                         (180, 20, 72)])
def test_decode_crop_counts_the_band_rows_it_inflates(tmp_path, native, top,
                                                      ph, rows):
    """A 200x96 record in bands of 64 rows: [70, 102) lies in band 1,
    [100, 140) in bands 1 and 2, [180, 200) in the last band of 8 rows
    (with band 2: 72 rows)."""
    path = str(tmp_path / "band.pack")
    arr = np.random.default_rng(4).integers(0, 65535, (200, 96, 3),
                                            dtype=np.uint16)
    with records.SidPackWriter(path, comp="zlib_band", band_rows=64) as w:
        w.add("k", arr)
    pack = native_loader.NativeSidPack(path)
    if not native:
        pack._handle = None
    assert pack.uses_native == native
    top = min(top, 200 - ph)
    off = pack.decode_crop("k", top, 10, ph, 24)
    on, rec, _ = _traced(tmp_path / "trace",
                         lambda: pack.decode_crop("k", top, 10, ph, 24))
    np.testing.assert_array_equal(off, on)
    assert _names(rec) == ["native_loader.decode"]
    assert rec["counters"] == {"native_loader.px_cropped": ph * 24,
                               "native_loader.px_inflated": rows * 96}
    pack.close()


def test_batched_decode_counts_whole_records_it_inflates(tmp_path):
    """Three 40x56 ``zlib`` records through the C batch path: one
    ``native_loader.decode`` span, every record inflated whole."""
    path = str(tmp_path / "whole.pack")
    rng = np.random.default_rng(5)
    with records.SidPackWriter(path, comp="zlib") as w:
        for k in "abc":
            w.add(k, rng.integers(0, 65535, (40, 56, 3), dtype=np.uint16))
    pack = native_loader.NativeSidPack(path)
    assert pack.uses_native
    args = (list("abc"), [0, 5, 8], [3, 0, 30], 16, 24)
    off = pack.decode_crop_batch(*args)
    on, rec, _ = _traced(tmp_path / "trace",
                         lambda: pack.decode_crop_batch(*args))
    np.testing.assert_array_equal(off, on)
    assert _names(rec) == ["native_loader.decode"]
    assert rec["counters"] == {"native_loader.px_cropped": 3 * 16 * 24,
                               "native_loader.px_inflated": 3 * 40 * 56}
    pack.close()


def test_trainer_steps_record_fetch_step_and_step_spans(
        debug_root, tmp_path, monkeypatch):
    trainer = _trainer(debug_root, tmp_path / "a", monkeypatch)
    _, rec, _ = _traced(tmp_path / "trace", trainer.train)
    spans = rec["spans"]
    for unit in (1, 2):
        mine = [s for s in spans if s.unit == unit]
        names = [s.name for s in mine]
        for name in ("trainer.fetch", "trainer.step") + STEP_SPANS:
            assert names.count(name) == 1, (unit, name)
        by = {s.name: s for s in mine}
        assert by["trainer.fetch"].parent is None
        assert by["trainer.step"].parent is None
        for name in STEP_SPANS:
            assert by[name].parent == "trainer.step"
            assert by["trainer.step"].t0 <= by[name].t0 \
                <= by[name].t1 <= by["trainer.step"].t1
        assert by["train_step.forward"].t1 <= by["train_step.backward"].t0
        assert by["train_step.backward"].t1 <= by["train_step.optimizer"].t0
    # the train loader decodes ahead on its pool: the decodes that the
    # profiled fetches submitted are recorded on the loader's threads
    main = threading.get_ident()
    decodes = [s for s in spans if s.name == "native_loader.decode"]
    assert decodes and trainer.train_loader.num_workers >= 1
    assert all(s.thread != main and s.parent is None and s.unit is None
               for s in decodes)
    assert {s.unit for s in spans if s.thread == main} == {1, 2}
    assert {s.thread for s in spans if s not in decodes} == {main}
    assert rec["counters"]["native_loader.px_cropped"] > 0
    assert rec["counters"]["loader.items"] == 2 * 2


class _Timed:
    """A data set that splits its draws from its loads; load ``i`` sleeps
    ``delay(i)`` s and opens a ``test.load`` span."""

    def __init__(self, n, delay):
        self.n, self.delay = n, delay

    def __len__(self):
        return self.n

    def draw(self, idx):
        return idx

    def load(self, idx, draws):
        time.sleep(self.delay(idx))
        with profiling.span("test.load"):
            return {"x": np.full((2,), draws, np.float32)}

    def __getitem__(self, idx):
        return self.load(idx, self.draw(idx))


def test_decode_ahead_counts_ready_items_and_waits():
    """Under a running ``torch.profiler``: the consumer waits for the two
    slow first loads (``loader.wait`` spans on its thread); after it
    pauses, every later item is ready (``loader.items_ready``);
    ``loader.items`` counts all eight; the loads that the profiled
    consumer submitted record on the pool's threads, and none that it
    submitted before the profiler started."""
    from lowlight_image_enhancement_tpu_torch.data import pipeline

    def run(delay):
        loader = pipeline.Loader(_Timed(8, delay), batch_size=2,
                                 shuffle=False, num_workers=2)
        stream = pipeline.epochs(loader, num_epochs=1)
        first = next(stream)
        time.sleep(0.3)
        return [first] + list(stream)

    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        batches = run(lambda i: 0.05 if i < 2 else 0.0)
    rec = profiling.record()
    assert [b["x"][:, 0].tolist() for b in batches] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    counters, main = rec["counters"], threading.get_ident()
    waits = [s for s in rec["spans"] if s.name == "loader.wait"]
    loads = [s for s in rec["spans"] if s.name == "test.load"]
    assert counters["loader.items"] == 8
    assert counters["loader.items_ready"] >= 6
    assert counters["loader.items_ready"] + len(waits) == 8
    assert waits and all(s.thread == main for s in waits)
    assert len(loads) == 8 and all(s.thread != main for s in loads)

    profiling.reset()
    loader = pipeline.Loader(_Timed(8, lambda i: 0.1 if i < 2 else 0.0),
                             batch_size=2, shuffle=False, num_workers=2)
    stream = pipeline.epochs(loader, num_epochs=1)
    next(stream)                          # submits items 0-7 unprofiled
    time.sleep(0.2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        rest = list(stream)
    assert len(rest) == 3 and profiling.record()["spans"] == [] \
        and profiling.record()["counters"] == {"loader.items": 6,
                                               "loader.items_ready": 6}
    profiling.reset()


def test_training_is_bit_identical_with_recording_on_and_off(
        debug_root, tmp_path, monkeypatch):
    off = _trainer(debug_root, tmp_path / "off", monkeypatch)
    off.train()
    on = _trainer(debug_root, tmp_path / "on", monkeypatch)
    _traced(tmp_path / "trace", on.train)
    for a, b in zip(_params(off), _params(on)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("span_name,op", [
    ("serving.forward", "aten::conv2d"),
    ("serving.h2d", "aten::contiguous"),
    ("train_step.forward", "aten::conv2d"),
    ("train_step.optimizer", "aten::addcmul_"),
])
def test_spans_are_trace_ranges_around_the_ops_they_launched(
        server, debug_root, tmp_path, monkeypatch, span_name, op):
    if span_name.startswith("serving"):
        fn = lambda: server.predict(_images((43, 64), 2))  # noqa: E731
    else:
        fn = _trainer(debug_root, tmp_path / "t", monkeypatch, iters=1).train
    _, rec, events = _traced(tmp_path / "trace", fn)
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e["name"] == span_name]
    assert len(ranges) == _names(rec).count(span_name) >= 1
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op" and e["name"] == op]
    assert any(r["ts"] <= o["ts"] and o["ts"] + o["dur"]
               <= r["ts"] + r["dur"] and o["tid"] == r["tid"]
               for r in ranges for o in ops)


def test_a_span_entered_before_the_profiler_is_not_recorded(tmp_path):
    profiling.reset()
    with profiling.span("outer"):
        with profiling.trace(str(tmp_path)):
            with profiling.span("inner", unit=7):
                torch.ones(4).sum()
    rec = profiling.record()
    assert [(s.name, s.parent, s.unit) for s in rec["spans"]] == [
        ("inner", None, 7)]
    assert getattr(profiling._local, "stack", []) == []


def test_trace_resets_the_recorder_and_the_cap_keeps_the_first_spans(
        tmp_path, monkeypatch):
    with profiling.trace(str(tmp_path / "a")):
        with profiling.span("first"):
            pass
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    with profiling.trace(str(tmp_path / "b")):
        for _ in range(3):
            with profiling.span("again"):
                pass
        profiling.count("n", 2)
        profiling.count("n", 3)
    rec = profiling.record()
    assert _names(rec) == ["again", "again"]
    assert rec["counters"] == {"n": 5}
    profiling.reset()
    assert profiling.record() == {"spans": [], "counters": {}}
