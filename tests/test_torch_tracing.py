"""The port's spans (`reverso_tpu_torch/utils/profiling.py`): recorded
only while a profiler captures, on the profiler's clock, one tree a call
at each benchmarked entry point; the idle-by-span reduction; the CLI's
`--trace-dir` with them. One test runs only on a card (`-m cuda`)."""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from reverso_tpu_torch.config import MODEL_PRESETS
from reverso_tpu_torch.models.pe import PerceptionEncoder
from reverso_tpu_torch.store.index import DeviceIndex, to_host
from reverso_tpu_torch.train.clip import ClipTrainer
from reverso_tpu_torch.utils import profiling
from reverso_tpu_torch.utils.profiling import OUTSIDE, Span, idle_by_span, span

TINY = dataclasses.replace(MODEL_PRESETS["test-tiny"], dtype="float32")


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def captured(fn):
    """The spans `fn` records under a CPU profile."""
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return profiling.spans()


def tree(records):
    """{name: (parent's name or None, waits)} of one call's spans, after
    checking they share one call id rooted at the root."""
    by_id = {r.id: r for r in records}
    roots = [r for r in records if r.parent is None]
    assert len(roots) == 1
    assert {r.call for r in records} == {roots[0].id}
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    return {r.name: (by_id[r.parent].name if r.parent else None, r.waits) for r in records}


def test_off_records_nothing_and_returns_the_shared_no_op():
    a, b = span("x"), span("y", waits=True)
    assert a is b is profiling._NO_SPAN
    with a:
        pass
    PerceptionEncoder(TINY, device="cpu", seed=0).encode_image(np.zeros((1, 32, 32, 3)))
    assert profiling.spans() == [] and profiling.spans_dropped == 0


def test_encode_image_tree():
    enc = PerceptionEncoder(TINY, device="cpu", seed=0)
    got = captured(lambda: enc.encode_image(np.random.rand(2, 32, 32, 3)))
    assert tree(got) == {
        "encode_image": (None, False),
        "encode_image.upload": ("encode_image", False),
        "encode_image.forward": ("encode_image", False),
        "encode_image.normalize": ("encode_image", False),
        "encode_image.download": ("encode_image", True),
    }


def test_index_search_and_to_host_trees():
    rows = np.random.default_rng(0).standard_normal((300, 16)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    index = DeviceIndex(rows, device="cpu")
    out = {}

    def call():
        s, i = index.search(rows[:3], 5)
        out["s"], out["i"] = to_host(s), to_host(i)

    got = captured(call)
    assert [r.name for r in got if r.parent is None] == ["index.search", "index.to_host",
                                                        "index.to_host"]
    assert tree([r for r in got if r.call == got[-3].call]) == {
        "index.search": (None, False),
        "index.search.queries": ("index.search", False),
        "index.search.mask": ("index.search", False),
        "index.search.pad": ("index.search", False),
        "index.search.scan": ("index.search", False),
    }
    assert all(r.waits for r in got if r.name == "index.to_host")
    assert out["i"][:, 0].tolist() == [0, 1, 2]


def test_train_step_tree():
    tr = ClipTrainer(TINY, device="cpu")
    a = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    got = captured(lambda: tr.train_step(a, a[:, :, ::-1]))
    assert tree(got) == {
        "train_step": (None, False),
        "train_step.upload": ("train_step", False),
        "train_step.forward": ("train_step", False),
        "train_step.backward": ("train_step", False),
        "train_step.grads": ("train_step", False),
        "train_step.optimizer": ("train_step", False),
        "train_step.sync": ("train_step", True),
    }


def test_a_span_encloses_its_ops_on_the_profilers_clock():
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            with span("mm"):
                torch.mm(x, x)
    got = profiling.spans()
    ops = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm")
    assert len(ops) == len(got) == 20
    for r, (s, e) in zip(sorted(got, key=lambda r: r.start_ns), ops):
        assert r.start_ns <= s and e <= r.end_ns


def test_a_full_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)

    def five():
        for _ in range(5):
            with span("x"):
                pass

    assert len(captured(five)) == 3
    assert profiling.spans_dropped == 2
    profiling.clear_spans()
    assert profiling.spans_dropped == 0


def test_a_span_on_a_second_thread_is_its_own_root():
    def work():
        with span("inner"):
            pass

    def call():
        with span("outer"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()

    got = {r.name: r for r in captured(call)}
    assert got["inner"].parent is None and got["inner"].call == got["inner"].id
    assert got["outer"].parent is None and got["inner"].thread != got["outer"].thread


def test_spans_add_no_device_sync(monkeypatch):
    def refuse():
        raise AssertionError("a span synchronized the device")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    rows = np.random.default_rng(0).standard_normal((50, 8)).astype(np.float32)
    index = DeviceIndex(rows, device="cpu")
    assert len(captured(lambda: to_host(index.search(rows[:2], 3)[1]))) == 6


def rec(name, s, e, id_, parent=None):
    return Span(name, s, e, id_, parent, id_ if parent is None else parent, 1, False)


def test_idle_by_span_on_synthetic_intervals():
    busy = [(10, 20), (15, 30), (50, 60), (90, 120)]
    spans = [rec("root", 5, 80, 1), rec("root.child", 35, 45, 2, 1), rec("late", 85, 95, 3)]
    got = idle_by_span(busy, spans, (0, 100))
    # idle: [0, 10) [30, 50) [60, 90); the window ends inside the last op
    assert got == {OUTSIDE: 5 + 5, "root": 5 + 5 + 5 + 20, "root.child": 10, "late": 5}
    assert sum(got.values()) == 10 + 20 + 30
    assert idle_by_span([], [], (0, 7)) == {OUTSIDE: 7}
    assert idle_by_span([(0, 7)], spans, (0, 7)) == {}
    # a span on another thread started later is the innermost
    other = Span("other", 40, 70, 4, None, 4, 2, False)
    assert idle_by_span([], spans[:1] + [other], (30, 80)) == {"root": 20, "other": 30}


def test_cli_trace_dir_writes_spans_and_prints_idle(tmp_path, monkeypatch, capsys):
    from reverso_tpu_torch import cli

    folder = tmp_path / "imgs"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
            folder / f"{i}.png")
    monkeypatch.delenv("REVERSO_PE_CKPT", raising=False)
    out = tmp_path / "trace"
    assert cli.main(["--device", "cpu", "--model", "test-tiny", "--db-root",
                     str(tmp_path / "db"), "--trace-dir", str(out), "build", str(folder),
                     "--name", "t", "--direct-pe"]) == 0
    with open(out / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "program_span"}
    assert {"build.embed", "encode_image", "encode_image.forward"} <= names
    err = capsys.readouterr().err
    assert "device idle by program span" in err and "encode_image" in err


def test_each_build_times_its_own_images(tmp_path):
    from reverso_tpu_torch.config import StoreConfig, default_config
    from reverso_tpu_torch.engine import Reverso

    rng = np.random.default_rng(0)
    for n in (3, 2):
        (tmp_path / f"f{n}").mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                tmp_path / f"f{n}" / f"{i}.png")
    cfg = default_config().replace(model=TINY,
                                   store=StoreConfig(root_dir=str(tmp_path / "db")))
    eng = Reverso(cfg, encoder=PerceptionEncoder(TINY, device="cpu"), device="cpu")
    assert "⏱️ embed: 3 images" in eng.create_database(str(tmp_path / "f3"), "a",
                                                      use_direct_pe=True)
    assert "⏱️ embed: 2 images" in eng.create_database(str(tmp_path / "f2"), "b",
                                                      use_direct_pe=True)
    # the engine keeps the last build's stage timers
    assert eng.metrics.counts["embed"] == 2


@pytest.mark.cuda
def test_a_waits_span_holds_its_download_on_the_card():
    """Under a CUDA-only profile a span that waits on `.cpu()` holds that
    copy, laid on the host's clock by `on_host_clock` (kineto's raw device
    times move against the host's by up to ms within a session)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType

    x = torch.randn(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert profiling._autograd_profiler._is_profiler_enabled
        for _ in range(20):
            y = x * 2
            with span("download", waits=True):
                y.cpu()
    got = sorted(profiling.spans(), key=lambda r: r.start_ns)
    events = prof.profiler.kineto_results.events()
    dev = [e for e in events if e.device_type() == DeviceType.CUDA]
    copies = [i for i, e in enumerate(dev) if "DtoH" in e.name()]
    assert len(got) == len(copies) == 20
    laid = profiling.on_host_clock(events)
    held = sorted(laid[i] for i in copies)
    for r, (s, e) in zip(got, held):
        assert r.start_ns <= s and e <= r.end_ns, (r, s, e)
