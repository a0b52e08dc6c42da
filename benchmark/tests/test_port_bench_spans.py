"""The readers of the program's spans, `metrics/host_ms.py` and
`metrics/program_idle_ms.py`, on synthetic spans and `Readings`: the
clock offset found from the waiting spans, clocks that drift apart and
dropped spans leading to None, a program without spans leading to None."""
import types

import pytest

from harness import cell as cellmod
from harness.trace import Readings
from reverso_tpu_torch.utils import profiling
from reverso_tpu_torch.utils.profiling import Span

US = 1000          # ns
BASE = 1_790_000_000_000_000_000   # a Unix-epoch ns, as kineto's clock reads
PERIOD = 2200 * US


def reader(name):
    return cellmod.load_module(cellmod.reader_path(name), "metric_" + name.split(".")[0])


def search_calls(n: int, jitter=lambda i: 0, extra: bool = False):
    """(spans, device ops on the spans' clock in ns) of `n` search-like
    calls: `index.search` launching an upload and a scan, then two
    `index.to_host`, each holding its pageable copy; `extra`: one more
    pageable copy a call, inside `index.search`, that nothing waits on."""
    spans, ops, ids = [], [], iter(range(1, 10 ** 6))
    for i in range(n):
        t = BASE + i * PERIOD + jitter(i)
        root = next(ids)
        spans.append(Span("index.search", t, t + 300 * US, root, None, root, 7, False))
        child = next(ids)
        spans.append(Span("index.search.scan", t + 150 * US, t + 290 * US, child, root, root, 7,
                          False))
        ops.append(("Memcpy HtoD (Pageable -> Device)", t + 100 * US, t + 120 * US))
        ops.append(("topk_scan_wg_kernel", t + 200 * US, t + 940 * US))
        if extra:
            ops.append(("Memcpy DtoH (Device -> Pageable)", t + 130 * US, t + 140 * US))
        for lo, hi in ((300, 1000), (1010, 1060)):
            w = next(ids)
            spans.append(Span("index.to_host", t + lo * US, t + hi * US, w, None, w, 7, True))
            ops.append(("Memcpy DtoH (Device -> Pageable)", t + (hi - 7) * US,
                        t + (hi - 2) * US))
    return spans, ops


def readings(ops_ns, calls: int, scale: float = 1.0):
    """`Readings` whose ops count in s from the first op, as
    `harness/trace.py::reduce` makes them; `scale` stretches the device's
    clock against the spans'."""
    t0 = min(s for _, s, _ in ops_ns)
    ops = [(n, scale * (s - t0) / 1e9, scale * (e - t0) / 1e9) for n, s, e in ops_ns]
    return Readings(None, 1.0, 0.5, ops, {}, {}, {"calls": calls}, {}, True)


@pytest.fixture
def program(monkeypatch):
    """The program's span buffer, filled by the test."""
    buf = {"spans": []}
    monkeypatch.setattr(profiling, "spans", lambda: list(buf["spans"]))
    monkeypatch.setattr(profiling, "spans_dropped", 0)
    return buf


def test_host_ms_is_roots_less_waits_a_call(program):
    spans, ops = search_calls(4)
    program["spans"] = spans
    # index.search 300 us a call; each to_host is a root that waits
    assert reader("host_ms.search").read(readings(ops, 4)) == pytest.approx(0.3)


def test_program_idle_ms_finds_the_offset(program, monkeypatch):
    monkeypatch.setattr("threading.get_native_id", lambda: 7)
    spans, ops = search_calls(40)
    program["spans"] = spans
    r = readings(ops, 40)
    mod = reader("program_idle_ms.search")
    _, offsets = mod.align(spans, r.ops)
    # the ops count from the first upload, 100 us after the first span;
    # the largest offset puts each copy's end at its span's, 2 us late;
    # the second to_host's copy starts 43 us after its span does, the
    # first's 693 us
    assert len(offsets) == 80
    for i, (offset, width) in enumerate(offsets):
        assert offset == pytest.approx(102e-6, abs=1e-9)
        assert width == pytest.approx((695e-6, 45e-6)[i % 2], abs=1e-9)
    # idle inside the roots (ops 2 us late): upload -> scan 80 us, scan ->
    # first copy 53 us, the second to_host before its copy 45 us; and the
    # next call's index.search before its upload, 102 us
    want = (40 * (80 + 53 + 45) + 39 * 102) * 1e-3 / 40
    assert mod.read(r) == pytest.approx(want, rel=1e-6)


def test_program_idle_ms_brute_force(program, monkeypatch):
    """Against the idle inside the roots counted microsecond by
    microsecond at the reader's offset, with calls that wander."""
    monkeypatch.setattr("threading.get_native_id", lambda: 7)
    spans, ops = search_calls(12, jitter=lambda i: (i * 37 % 11) * 13 * US)
    program["spans"] = spans
    r = readings(ops, 12)
    mod = reader("program_idle_ms.search")
    late = round(1e6 * mod.align(spans, r.ops)[1][0][0]) - 100
    assert late == 2
    lo = min(s for _, s, _ in ops) - late * US
    busy = {t for _, s, e in ops for t in range((s - lo) // US, (e - lo) // US)}
    roots = {t for s in spans if s.parent is None
             for t in range((s.start_ns - lo) // US, (s.end_ns - lo) // US)}
    want = sum(1 for t in range(min(busy), max(busy)) if t not in busy and t in roots)
    assert mod.read(r) == pytest.approx(want * 1e-3 / 12, rel=1e-6)


@pytest.mark.parametrize("how", ["wander", "step"])
def test_a_device_clock_that_moves_is_followed(program, monkeypatch, capsys, how):
    """The card's device times against the host's: 0.15 us a ms (132 us
    over the window, three times what a short span leaves room for, so
    no one offset would do), or a step of 6 ms between two calls."""
    monkeypatch.setattr("threading.get_native_id", lambda: 7)
    spans, ops = search_calls(400)
    program["spans"] = spans
    if how == "step":
        cut = BASE + 200 * PERIOD
        ops = [(n, s + (s > cut) * 6000 * US, e + (s > cut) * 6000 * US) for n, s, e in ops]
    r = readings(ops, 400, scale=1.00015 if how == "wander" else 1.0)
    mod = reader("program_idle_ms.search")
    _, offsets = mod.align(spans, r.ops)
    moved = max(o for o, _ in offsets) - min(o for o, _ in offsets)
    assert moved == pytest.approx(0.15e-6 * 878 if how == "wander" else 6e-3, rel=0.01)
    assert mod.read(r) == pytest.approx((400 * (80 + 53 + 45) + 399 * 102) * 1e-3 / 400,
                                        rel=0.01)
    assert "a range of" in capsys.readouterr().err


@pytest.mark.parametrize("how", ["first_copy_lost", "copy_lost", "extra_copies",
                                 "first_op_early"])
def test_copies_that_do_not_pair_read_none(program, monkeypatch, capsys, how):
    """A copy lost anywhere but the window's end, copies that no span
    waits on, or a first copy that would put the first device operation
    before its call began."""
    monkeypatch.setattr("threading.get_native_id", lambda: 7)
    spans, ops = search_calls(40, extra=how == "extra_copies")
    program["spans"] = spans
    copies = [i for i, op in enumerate(ops) if "DtoH" in op[0]]
    if how in ("first_copy_lost", "copy_lost"):
        del ops[copies[0 if how == "first_copy_lost" else 41]]
    if how == "first_op_early":
        # a device operation 1 ms before the first call, which no span launched
        ops.append(("kernel", BASE - 1000 * US, BASE - 990 * US))
    assert reader("program_idle_ms.search").read(readings(ops, 40)) is None
    assert "do not pair" in capsys.readouterr().err


def test_a_window_may_lose_its_last_copies(program, monkeypatch):
    monkeypatch.setattr("threading.get_native_id", lambda: 7)
    spans, ops = search_calls(40)
    program["spans"] = spans
    mod = reader("program_idle_ms.search")
    want = mod.read(readings(ops, 40))
    del ops[max(i for i, op in enumerate(ops) if "DtoH" in op[0])]
    assert mod.read(readings(ops, 40)) == pytest.approx(want, rel=0.01)


def test_dropped_or_missing_spans_read_none(program, monkeypatch):
    monkeypatch.setattr("threading.get_native_id", lambda: 7)
    spans, ops = search_calls(4)
    r = readings(ops, 4)
    for name in ("host_ms.search", "program_idle_ms.search"):
        program["spans"] = []
        assert reader(name).read(r) is None
        program["spans"] = spans
        monkeypatch.setattr(profiling, "spans_dropped", 1)
        assert reader(name).read(r) is None
        monkeypatch.setattr(profiling, "spans_dropped", 0)
        assert reader(name).read(r) is not None


def test_a_program_without_spans_reads_none(monkeypatch):
    import reverso_tpu_torch.utils as utils

    monkeypatch.setattr(utils, "profiling", types.ModuleType("profiling"))
    spans, ops = search_calls(4)
    for name in ("host_ms.train", "program_idle_ms.train"):
        assert reader(name).read(readings(ops, 4)) is None
