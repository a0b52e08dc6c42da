"""Packaging contracts of the PyTorch port (`reverso_tpu_torch`).

* it imports and runs the direct-embed and region builds + search, the
  vision-checkpoint loaders and the euclid / manhattan / PQ / host /
  MaxSim searches with `jax` blocked;
* its host modules are byte-identical copies of the JAX package's;
* no device fallback: asking for CUDA without a card raises, and a kernel
  wrapper given a tensor that is neither on the CPU nor on a CUDA card
  raises instead of running the plain version;
* chip_smoke.py refuses to run without a card;
* the trainer imports and takes a step with `jax` blocked.
"""
import filecmp
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "reverso_tpu_torch")
HOST_COPIES = ("config.py", "utils/logging.py", "store/persist.py",
               "detect/regions.py", "detect/wordpiece.py", "viz.py",
               "ingest/images.py", "ingest/pipeline.py", "store/filter.py",
               "store/text.py", "native.py", "store/sparse.py",
               "store/formula.py", "detect/clipbpe.py")


def _run(code: str, cwd: str, timeout: int = 120):
    """Run `code` in a fresh interpreter on one CPU thread. The cap is a
    precaution: under the parallel test run a child on every core
    oversubscribes the machine. A rare failure of the loaders'
    bit-for-bit check in such a child has not been reproduced, and its
    cause is not known."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_runs_with_jax_blocked(tmp_path):
    proc = _run(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import os, numpy as np
        from PIL import Image
        from reverso_tpu_torch.compat import SimpleReverso
        from reverso_tpu_torch.config import MODEL_PRESETS, StoreConfig, default_config
        from reverso_tpu_torch.models.pe import PerceptionEncoder
        root = {str(tmp_path)!r}
        folder = os.path.join(root, "images"); os.makedirs(folder)
        rng = np.random.default_rng(0)
        for j in range(6):
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                os.path.join(folder, f"{{j}}.png"))
        cfg = default_config().replace(model=MODEL_PRESETS["test-tiny"],
                                       store=StoreConfig(root_dir=os.path.join(root, "db")))
        sr = SimpleReverso(cfg, encoder=PerceptionEncoder(cfg.model, device="cpu"),
                           device="cpu")
        text = sr.create_database(folder, "demo", use_direct_pe=True)
        assert "ready for searching" in text, text
        print(sr.load_database("demo"))
        sr.process_image_direct_pe(Image.open(os.path.join(folder, "3.png")))
        text, items = sr.search_similar(0.0, 3)
        assert items[0]["filename"] == "3.png", text
        # the capacity slice: a payload filter, the int8 IVF and binary indexes
        emb = sr._engine.region_embeddings
        _, ids = sr._engine.search_batch(emb, 3, filter=dict(filename="3.png"))
        assert ids[0].tolist()[:1] != [-1] and (ids[:, 1:] == -1).all(), ids
        from reverso_tpu_torch.store import BinaryIndex, IVFIndex
        vecs = rng.standard_normal((64, 32)).astype(np.float32)
        ivf = IVFIndex(vecs, n_clusters=4, dtype="int8", spill=0.1, balance=1.5,
                       device="cpu")
        assert ivf.search(vecs[:2], 3, nprobe=4)[1][:, 0].tolist() == [0, 1]
        assert BinaryIndex(vecs, device="cpu").search(vecs[:1], 3)[1].shape == (1, 3)

        # the region path: a seeded tiny GroundingDINO + SAM
        from reverso_tpu_torch.config import DetectorConfig
        from reverso_tpu_torch.detect.grounded import GroundedSamDetector
        from reverso_tpu_torch.detect.wordpiece import WordPieceTokenizer
        from reverso_tpu_torch.models.groundingdino import tiny_test_config
        from reverso_tpu_torch.models.sam import tiny_sam_config
        import reverso_tpu_torch.models.swin, reverso_tpu_torch.models.text
        import reverso_tpu_torch.ops.deformable
        vocab = os.path.join(root, "vocab.txt")
        open(vocab, "w").write(chr(10).join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", ".", "person", "car"]))
        det = GroundedSamDetector(
            tokenizer=WordPieceTokenizer(vocab), seed=1, device="cpu",
            cfg=DetectorConfig(box_threshold=0.0, text_threshold=0.0, max_regions=2),
            dino_cfg=tiny_test_config(), sam_cfg=tiny_sam_config(), dino_size=64,
            text_len=8)
        sr = SimpleReverso(cfg, encoder=PerceptionEncoder(cfg.model, device="cpu"),
                           detector=det, device="cpu")
        text = sr.create_database(folder, "regions", text_prompt="person . car")
        assert "ready for searching" in text, text
        assert sr.detect_regions(Image.open(os.path.join(folder, "3.png"))) > 0
        sr.extract_embeddings(Image.open(os.path.join(folder, "3.png")))
        text, items = sr.search_similar(-1.0, 3)
        assert items and items[0]["filename"] == "3.png", text
        # ROI pooling, the int8 tower and the two-stage int8 search
        import dataclasses, torch
        sr._engine.config = cfg.replace(ingest=dataclasses.replace(
            cfg.ingest, region_embed_mode="region"))
        sr.detect_regions(Image.open(os.path.join(folder, "3.png")))
        embs, _ = sr.extract_embeddings(Image.open(os.path.join(folder, "3.png")))
        assert len(embs) > 0 and np.isfinite(np.stack(embs)).all()
        enc8 = PerceptionEncoder(cfg.model, device="cpu", quant="int8")
        assert np.isfinite(enc8.encode_image(np.zeros((1, 32, 32, 3), np.float32))).all()
        from reverso_tpu_torch.ops.topk_int8 import cosine_topk_int8, quantize_rows
        v = torch.from_numpy(vecs)
        assert cosine_topk_int8(*quantize_rows(v), v, v[:2], 3)[1][:, 0].tolist() == [0, 1]
        assert not [m for m in sys.modules if m.split(".")[0] == "reverso_tpu"]
        print("OK", len(items))
    """, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK 3" in proc.stdout


def test_port_loaders_and_search_ops_run_with_jax_blocked(tmp_path):
    """`from_torch` of an OpenAI-CLIP-scheme `.pt`, `from_checkpoint` of the
    port's own msgpack, a euclid, a manhattan and a PQ search, the host
    index and a MaxSim search, with `jax` and `flax` blocked."""
    proc = _run(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import os, numpy as np, torch
        from chip_smoke import openai_clip_state_dict
        from reverso_tpu_torch.config import MODEL_PRESETS
        from reverso_tpu_torch.models.checkpoint import save_params
        from reverso_tpu_torch.models.convert import flax_params_from_vision
        from reverso_tpu_torch.models.pe import PerceptionEncoder
        root = {str(tmp_path)!r}
        cfg = MODEL_PRESETS["test-tiny"]
        enc = PerceptionEncoder(cfg, seed=2, device="cpu")
        tree = flax_params_from_vision(enc.module.state_dict())
        sd = openai_clip_state_dict(enc.module.state_dict())
        torch.save(sd, os.path.join(root, "pe.pt"))
        imgs = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
        want = enc.encode_image(imgs)
        got = PerceptionEncoder.from_torch(os.path.join(root, "pe.pt"), cfg, device="cpu")
        assert got.family == "pe", ("from_torch: family", got.family)
        out = got.encode_image(imgs)
        assert np.array_equal(out, want), ("from_torch", np.abs(out - want).max())
        save_params(os.path.join(root, "pe.msgpack"), tree, meta={{"preset": "test-tiny"}})
        back = PerceptionEncoder.from_checkpoint(os.path.join(root, "pe.msgpack"), device="cpu")
        out = back.encode_image(imgs)
        assert np.array_equal(out, want), ("from_checkpoint", np.abs(out - want).max())

        from reverso_tpu_torch.store import DeviceIndex, HostIndex, MultiVecIndex, PQIndex
        rng = np.random.default_rng(1)
        v = rng.standard_normal((500, 32)).astype(np.float32)
        for dist in ("euclid", "manhattan"):
            s, i = DeviceIndex(v, distance=dist, device="cpu").search(v[7] + 0.01, 3)
            assert int(i[0, 0]) == 7 and float(s[0, 0]) <= 0, (dist, s, i)
            hi = HostIndex(v, distance=dist).search(v[7] + 0.01, 3)[1]
            assert int(hi[0, 0]) == 7, ("host " + dist, hi)
        u = v / np.linalg.norm(v, axis=1, keepdims=True)
        s, i = PQIndex(u, iters=3, device="cpu").search(u[:4], 20)
        assert i.shape == (4, 20) and (i[:, 0] == torch.arange(4)).float().mean() >= 0.75, \
            ("pq", i[:, :3])
        mv = MultiVecIndex(u, np.arange(1, 501), dtype="float32", device="cpu")
        assert mv.search([u[3]], 2)[1][0, 0] == 3, "maxsim"
        assert not [m for m in sys.modules if m.split(".")[0] == "reverso_tpu"], "jax package"
        print("OK loaders")
    """, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK loaders" in proc.stdout


@pytest.mark.parametrize("rel", HOST_COPIES)
def test_host_copies_are_byte_identical(rel):
    assert filecmp.cmp(os.path.join(REPO, "reverso_tpu", rel),
                       os.path.join(PORT, rel), shallow=False)


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|reverso_tpu)\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert offenders == []


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from reverso_tpu_torch.config import MODEL_PRESETS
    from reverso_tpu_torch.models.pe import PerceptionEncoder
    from reverso_tpu_torch.store import DeviceIndex

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PerceptionEncoder(MODEL_PRESETS["test-tiny"], device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceIndex(torch.zeros(4, 8).numpy(), device="cuda")
    from reverso_tpu_torch import cli
    from reverso_tpu_torch.ingest.video import content_scores_batched
    from reverso_tpu_torch.models.cliptext import ClipTextConfig, TextEmbedder

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TextEmbedder(ClipTextConfig(vocab_size=8, width=8, depth=1, num_heads=2,
                                    context_length=4, embed_dim=4), None, None,
                     device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        content_scores_batched(np.zeros((2, 4, 4, 3), np.uint8), device="cuda")
    # the command line defaults to CUDA and names the option that runs on the CPU
    with pytest.raises(RuntimeError, match="CUDA is not available.*--device cpu"):
        cli.main(["--device", "cuda", "list"])
    with pytest.raises(RuntimeError, match="CUDA is not available.*--device cpu"):
        cli.main(["list"])


def test_wrappers_never_fall_back_for_device_tensors():
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops import (cosine_topk, flash_attention,
                                       flash_attention_heads, fused_mlp,
                                       ms_deform_attn)
    from reverso_tpu_torch.ops.binary import binary_topk
    from reverso_tpu_torch.ops.ivf_scan import ivf_probe_scan
    from reverso_tpu_torch.ops.fused_mlp import fused_mlp_int8, quantize_mlp_weights
    from reverso_tpu_torch.ops.topk import cosine_topk_int8_exact
    from reverso_tpu_torch.ops.topk_int8 import cosine_topk_int8, topk_int8_rows

    m = lambda *shape: torch.empty(*shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_heads(m(1, 5, 16), m(1, 5, 16), m(1, 5, 16), heads=2)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp(m(3, 8), m(16, 8), m(16), m(8, 16), m(8))
    with pytest.raises(ValueError, match="CUDA"):
        cosine_topk(m(10, 8), m(2, 8), 3)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(m(1, 2, 5, 8), m(1, 2, 5, 8), m(1, 2, 5, 8))
    # bf16 at a tensor-core head dim: the route of flash_attn_tc / flash_heads_tc
    b16 = lambda *shape: m(*shape).to(torch.bfloat16)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(b16(1, 2, 5, 16), b16(1, 2, 5, 16), b16(1, 2, 5, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_heads(b16(1, 5, 32), b16(1, 5, 32), b16(1, 5, 32), heads=2)
    assert kernels.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(m(1, 2, 4, 8), m(1, 2, 4, 8), m(1, 2, 4, 8),
                        rel_bias=(m(1, 2, 4, 2), m(1, 2, 4, 2), 2))
    with pytest.raises(ValueError, match="CUDA"):
        ms_deform_attn(m(1, 5, 2, 4), ((1, 2), (1, 3)), m(1, 3, 2, 2, 1, 2),
                       m(1, 3, 2, 2, 1))
    with pytest.raises(ValueError, match="CUDA"):
        cosine_topk(m(10, 8), m(2, 8), 3, row_mask=m(10).bool())
    with pytest.raises(ValueError, match="CUDA"):
        cosine_topk_int8_exact(m(10, 8).to(torch.int8), 0.01, m(2, 8), 3)
    with pytest.raises(ValueError, match="CUDA"):
        binary_topk(m(10, 1).to(torch.uint8), m(2, 8), 3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ivf_probe_scan(m(10, 8), m(2, 8), None, None, m(2, 3).int(), m(2, 3).int(),
                       k=3, cmax=4, int8=False)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp(m(3, 8), m(16, 8), m(16), m(8, 16), m(8), quant=True)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_int8(m(3, 8), quantize_mlp_weights(m(16, 8), m(16), m(8, 16), m(8),
                                                     torch.float32))
    i8 = m(10, 8).to(torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        topk_int8_rows(i8, m(10), m(2, 8).to(torch.int8), m(2), 3)
    with pytest.raises(ValueError, match="CUDA"):
        cosine_topk_int8(i8, m(10), m(10, 8), m(2, 8), 3)


@pytest.mark.parametrize("source,launchers", [
    ("fused_mlp.cu", {"rv_split_parts", "rv_fused_mlp_split", "rv_fused_mlp_tc",
                      "rv_fused_mlp_int8"}),
    ("ms_deform.cu", {"rv_ms_deform"}),
    ("flash_heads.cu", {"rv_flash_heads_tc"}),
    ("flash_heads_split.cu", {"rv_flash_heads_split"}),
    ("ivf_scan.cu", {"rv_ivf_scan", "rv_ivf_plan"}),
    ("flash_heads_bwd_tc.cu", {"rv_flash_heads_bwd_tc", "rv_flash_heads_bwd_parts"}),
    ("fused_mlp_bwd.cu", {"rv_fused_mlp_bwd_split", "rv_fused_mlp_bwd_tc"}),
    ("probe_dma.cu", {"rv_probe_dma"}),
    ("probe_mxu.cu", {"rv_probe_mxu"}),
    ("probe_scan.cu", {"rv_probe_scan"}),
    ("probe_dyn_dma.cu", {"rv_probe_dyn_dma"}),
    ("probe_gather.cu", {"rv_probe_gather"}),
])
def test_signatures_match_k5_k8_launchers(source, launchers):
    """The ctypes argument lists of the K3, K4/K5, K8 and K11 launchers, of
    K3's and K4's backward kernels and of the hardware probes' (P1-P5) in
    `kernels._SIGNATURES` against their `extern "C"` declarations, parsed
    from the sources."""
    from reverso_tpu_torch import kernels
    pat = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)
    found = {}
    with open(os.path.join(kernels.CSRC, source)) as f:
        for name, args in pat.findall(f.read()):
            found[name] = [kernels._P if "*" in a else
                           kernels._F if " ".join(a.split()).startswith("float") else kernels._I
                           for a in args.split(",")]
    assert set(found) == launchers
    for name, types in found.items():
        assert kernels._SIGNATURES[name] == types, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_k8_wrappers_raise_off_cuda(dtype):
    """K5 and K8 given tensors neither on the CPU nor on a card (meta) raise
    before any launch, at widths the int8 kernel pads (W = 72, H = 200) and
    an odd head dim; no launch is counted, by kernel or by shape."""
    from reverso_tpu_torch import kernels
    from reverso_tpu_torch.ops import fused_mlp, ms_deform_attn
    from reverso_tpu_torch.ops.fused_mlp import fused_mlp_int8, quantize_mlp_weights

    m = lambda *shape: torch.empty(*shape, device="meta", dtype=dtype)
    before, shapes = dict(kernels.launches), dict(kernels.shape_launches)
    qw = quantize_mlp_weights(m(200, 72), m(200), m(72, 200), m(72), dtype)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_int8(m(5, 72), qw)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp(m(5, 72), m(200, 72), m(200), m(72, 200), m(72), quant=True)
    with pytest.raises(ValueError, match="CUDA"):
        ms_deform_attn(m(2, 7, 3, 5), ((1, 2), (1, 5)), m(2, 4, 3, 2, 3, 2).float(),
                       m(2, 4, 3, 2, 3).float())
    assert kernels.launches == before and dict(kernels.shape_launches) == shapes


def test_reset_counts_clears_shape_launches():
    from reverso_tpu_torch import kernels
    kernels.shape_launches[("ms_deform", (1, 2))] += 3
    kernels.reset_counts()
    assert not kernels.shape_launches
    assert all(v == 0 for v in kernels.launches.values())


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for cwd in (REPO, str(tmp_path)):
        script = os.path.join(REPO, "chip_smoke.py")
        if cwd != REPO:    # alone in a directory, without the package
            alone = tmp_path / "chip_smoke.py"
            alone.write_text(open(script).read())
            script = str(alone)
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, PYTHONPATH=""))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_port_surface_runs_with_jax_blocked(tmp_path):
    """The universal query, the mutations and the batcher with `jax` and
    `flax` blocked: query, query_batch, a grouped search, upsert /
    update_vectors / delete_points, and a batched search_similar."""
    proc = _run(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import numpy as np
        from reverso_tpu_torch.config import StoreConfig, default_config
        from reverso_tpu_torch.engine import Reverso
        from reverso_tpu_torch.store import VectorStore
        root = {str(tmp_path)!r}
        rng = np.random.default_rng(0)
        v = rng.standard_normal((300, 16)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        with VectorStore.create(root, "db", 16) as s:
            s.append(v, [{{"folder": i % 4, "region_id": f"r{{i}}"}} for i in range(300)])
        eng = Reverso(default_config().replace(store=StoreConfig(root_dir=root)), device="cpu")
        eng.load_database("db")
        assert eng.query(5, k=3)[0]["id"] == 5
        res = eng.query_batch([{{"query": v[1], "k": 2}}, {{"query": "r2", "k": 2,
                                                          "filter": {{"folder": 2}}}}])
        assert [r[0]["id"] for r in res] == [1, 2]
        assert len(eng.search_groups(-1.0, 3, embeddings=v[:1], group_by="folder")[1]) == 3
        assert eng.upsert_points(v[:2]).startswith("✅ Upserted 2")
        assert eng.update_vectors([3], v[4:5]).startswith("✅")
        assert eng.delete_points({{"folder": 3}}).startswith("✅ Deleted 75")
        text, items = eng.search_similar(-1.0, 3, embeddings=v[6:7], use_batcher=True)
        assert items[0]["id"] == 6 - 1, items
        eng.searcher.close()
        assert not [m for m in sys.modules if m.split(".")[0] == "reverso_tpu"]
        print("OK surface")
    """, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK surface" in proc.stdout


def test_port_entry_points_run_with_jax_blocked(tmp_path):
    """The `reverso-torch` command (build, search, search-text) and one web-UI
    request, with `jax` and `flax` blocked."""
    proc = _run(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import dataclasses, io, json, os, threading, urllib.request
        from contextlib import redirect_stdout
        import numpy as np
        from PIL import Image
        from reverso_tpu_torch import cli
        from reverso_tpu_torch.detect.clipbpe import ClipBPETokenizer
        from reverso_tpu_torch.models.checkpoint import save_params
        from reverso_tpu_torch.models.cliptext import ClipTextConfig, TextEmbedder
        from reverso_tpu_torch.models.convert import flax_params_from_text
        root = {str(tmp_path)!r}
        folder = os.path.join(root, "images"); os.makedirs(folder)
        rng = np.random.default_rng(0)
        for j in range(5):
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                os.path.join(folder, f"{{j}}.png"))
        vocab = {{"a": 0, "c": 1, "t": 2, "<|startoftext|>": 3, "<|endoftext|>": 4}}
        open(os.path.join(root, "vocab.json"), "w").write(json.dumps(vocab))
        open(os.path.join(root, "merges.txt"), "w").write("#version: 0.2")
        tok = ClipBPETokenizer(os.path.join(root, "vocab.json"),
                               os.path.join(root, "merges.txt"), context_length=8)
        tcfg = ClipTextConfig(vocab_size=5, width=16, depth=1, num_heads=2, context_length=8,
                              embed_dim=32, eot_token_id=4)
        text = TextEmbedder(tcfg, None, tok, device="cpu")
        save_params(os.path.join(root, "text.msgpack"),
                    flax_params_from_text(text.module.state_dict()),
                    meta={{"config": dataclasses.asdict(tcfg)}})
        os.environ.update(REVERSO_CLIP_TEXT_CKPT=os.path.join(root, "text.msgpack"),
                          REVERSO_CLIP_VOCAB=os.path.join(root, "vocab.json"),
                          REVERSO_CLIP_MERGES=os.path.join(root, "merges.txt"))
        base = ["--device", "cpu", "--model", "test-tiny", "--db-root", os.path.join(root, "db")]
        step = "build"
        assert cli.main(base + ["build", folder, "--name", "demo", "--direct-pe"]) == 0, step
        for step, argv in (("search", ["search", os.path.join(folder, "3.png")]),
                           ("search-text", ["search-text", "a cat"])):
            out = io.StringIO()
            with redirect_stdout(out):
                rc = cli.main(base + argv + ["--name", "demo", "--json", "--threshold", "-1"])
            hits = json.loads(out.getvalue())
            assert rc == 0 and hits, (step, rc, out.getvalue())
            if step == "search":
                assert hits[0]["filename"] == "3.png", (step, hits)
        step = "ui"
        from reverso_tpu_torch.ui.server import create_server
        engine = cli._make_engine(cli.build_parser().parse_args(base + ["list"]))
        engine.load_database("demo")
        srv = create_server(engine, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{{srv.server_address[1]}}/api/query/search_text",
            data=json.dumps({{"text": "a cat", "threshold": -1.0}}).encode(), method="POST")
        with urllib.request.urlopen(req) as r:
            body = json.loads(r.read())
        srv.shutdown()
        engine.searcher.close()
        assert len(body["results"]) == 5, (step, body)
        assert not [m for m in sys.modules if m.split(".")[0] == "reverso_tpu"]
        print("OK entry points")
    """, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK entry points" in proc.stdout


def test_trainer_runs_with_jax_blocked(tmp_path):
    """`reverso_tpu_torch.train` imports and takes one step at test-tiny on
    the CPU, saves and restores its state, with `jax`, `flax` and `optax`
    blocked."""
    proc = _run(f"""
        import sys
        for name in ("jax", "flax", "optax", "orbax"):
            sys.modules[name] = None
        import os, numpy as np
        from reverso_tpu_torch.config import MODEL_PRESETS
        from reverso_tpu_torch.train import ClipTrainer, param_partition_spec
        from reverso_tpu_torch.train.checkpoint import restore_train_state, save_train_state
        tr = ClipTrainer(MODEL_PRESETS["test-tiny"], device="cpu")
        rng = np.random.default_rng(0)
        a = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
        loss = tr.train_step(a, a[:, :, ::-1])
        assert np.isfinite(loss) and int(tr.step) == 1, loss
        assert param_partition_spec(tr.state.params)["blocks.0.mlp.fc1.bias"] == ("model",)
        path = os.path.join({str(tmp_path)!r}, "state.pt")
        save_train_state(path, tr.state)
        assert int(restore_train_state(path, tr.state).step) == 1
        assert not [m for m in sys.modules if m.split(".")[0] == "reverso_tpu"]
        print("OK trainer", loss)
    """, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK trainer" in proc.stdout
