"""The host's own work a call, read by every `host_ms.<cells>` metric from
the program's spans over the traced window
(`reverso_tpu_torch/utils/profiling.py::span`): the time of the root
spans (`encode_image`; `index.search` and `index.to_host`; `train_step`)
less that of the spans that wait on the device (`encode_image.download`,
`index.to_host`, `train_step.sync`), over the window's calls. It counts
the pageable upload the host blocks on. The profiler slows a call's host
side (a training step 1.14-1.35x, embedding and search up to 1.07x), so
a reading is high by up to as much. None where the program recorded no
span (a program without spans) or dropped any. Each span's own time a
call (less its children's) goes to the log."""
import sys


def program_spans():
    """The program's spans of the traced window, or None where it has no
    spans, recorded none, or dropped any."""
    try:
        from reverso_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans") or profiling.spans_dropped:
        return None
    return profiling.spans() or None


def own_ms(records, calls: int) -> dict:
    """{span name: its time less its children's, ms a call}."""
    own = {r.id: r.end_ns - r.start_ns for r in records}
    for r in records:
        if r.parent in own:
            own[r.parent] -= r.end_ns - r.start_ns
    out = {}
    for r in records:
        out[r.name] = out.get(r.name, 0.0) + own[r.id] / 1e6 / calls
    return out


def host_ms(records, calls: int):
    if not records or not calls:
        return None
    roots = sum(r.end_ns - r.start_ns for r in records if r.parent is None)
    waits = sum(r.end_ns - r.start_ns for r in records if r.waits)
    return (roots - waits) / 1e6 / calls


def read(r):
    records, calls = program_spans(), r.work["calls"]
    value = host_ms(records, calls)
    if value is not None:
        by_name = sorted(own_ms(records, calls).items(), key=lambda x: -x[1])
        print(f"host_ms: {value:.4f} ms a call over {calls} calls, {len(records)} spans; own "
              f"ms a call: {', '.join(f'{n} {v:.4f}' for n, v in by_name)}",
              file=sys.stderr, flush=True)
    return value
