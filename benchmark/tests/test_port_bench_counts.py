"""The frozen counts against the formulas they were copied from
(`chip_smoke.py`), at the cells' shapes, and the model's operations."""
import importlib.util
import os

import pytest

from counts import kernels, model
from harness import cell as cellmod

SMOKE = os.path.join(cellmod.ROOT, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    if not os.path.exists(SMOKE):
        pytest.skip("chip_smoke.py is not beside the benchmark")
    spec = importlib.util.spec_from_file_location("chip_smoke_counts", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SHAPES = [
    ("mlp_bound", (64 * 577, 1024, 4096, 2, "bfloat16")),
    ("mlp_bound", (4616, 1024, 4096, 2, "bfloat16")),
    ("heads_bound", (64, 577, 1024, 16, 2, "bfloat16")),
    ("heads_bound", (8, 577, 1024, 16, 2, "bfloat16")),
    ("topk_bound", ("topk_stream", 256, 1_000_000, 1024, 10, False)),
    ("topk_bound", ("topk_stream", 1, 1_000_000, 1024, 10, True)),
    ("topk_bound", ("topk_stream_f32", 64, 1_000_000, 1024, 10, False)),
    ("heads_bwd_bound", (16, 577, 1024, 16, 2, "bfloat16")),
    ("mlp_bwd_bound", (16 * 577, 1024, 4096, 2, "bfloat16")),
]


@pytest.mark.parametrize("fn,args", SHAPES)
def test_bounds_match_the_smoke_script(smoke, fn, args):
    mine, by = getattr(kernels, fn)(*args)
    theirs, their_by = getattr(smoke, fn)(*args)
    assert mine == pytest.approx(float(theirs), rel=1e-12) and by == their_by


def test_kernel_part_of_mlp_backward(smoke):
    args = (9232, 1024, 4096, 2, "bfloat16")
    assert kernels.mlp_bwd_bound(*args, kernel_only=True)[0] == pytest.approx(
        float(smoke.mlp_bwd_bound(*args, kernel_only=True)[0]), rel=1e-12)


def test_rope_tables_leave_the_bound_without_rope():
    with_rope = kernels.heads_bound(64, 577, 1024, 16, 2, "bfloat16")[0]
    without = kernels.heads_bound(64, 577, 1024, 16, 2, "bfloat16", rope=False)[0]
    assert without <= with_rope
    # at B = 64 the bytes bound it (0.0904 ms), the operations a hair below
    assert kernels.heads_bound(64, 577, 1024, 16, 2, "bfloat16")[1] == "bytes"
    assert kernels.heads_bound(64, 577, 1024, 16, 2, "bfloat16", rope=False)[1] == "bytes"


def test_tower_flops_at_the_published_shapes():
    pe = cellmod.load_cell("pe_l14.embed_b64", 1, 1.0).config
    clip = cellmod.load_cell("clip_l14.embed_b64", 1, 1.0).config
    assert model.seq_len(pe) == 577 and model.hidden(pe) == 4096
    # 24 blocks of 15.9 GFLOP (381.5), the patch embedding (0.7) and the
    # pool's key and value projections over 577 tokens (2.4)
    assert 384e9 < model.tower_flops(pe) < 385e9
    assert model.tower_flops(clip) < model.tower_flops(pe)
    assert model.train_step_flops(pe, 16) == 3 * 32 * model.tower_flops(pe)
    assert model.scan_flops(256, 1_000_000, 1024) == 2 * 256 * 1_000_000 * 1024
