"""The web UI of the PyTorch port (`reverso_tpu_torch.ui.server`) on the CPU.

The ten tests of `tests/test_ui.py` run here unchanged over a live HTTP
server of the port (test-tiny engine in fp32, stub detector,
`device="cpu"`): they are imported, and this module's `server` fixture
serves them. One more test serves one store from a JAX server and a port
server, on the same encoder weights, and holds their search endpoints'
ids and scores against each other (scores to 1e-5: both towers run in
fp32, the JAX package's scan in fp32 on the CPU and the port's plain scan
in fp32 from bf16 rows).
"""
import dataclasses
import shutil
import threading

import numpy as np
import pytest

from test_pipeline import make_corpus
from test_ui import (get, img_b64, post,  # noqa: F401  (the tests below use them)
                     test_error_paths, test_full_ui_flow,
                     test_hybrid_spaces_through_universal_endpoint,
                     test_index_and_about, test_recommend_and_points_endpoints,
                     test_search_groups_endpoint, test_search_text_endpoint,
                     test_session_isolation, test_stats_endpoint,
                     test_visualize_selection)

SCORE_TOL = 1e-5


def _port_engine(root, encoder=None):
    from reverso_tpu_torch.config import MODEL_PRESETS, default_config
    from reverso_tpu_torch.detect import StubDetector
    from reverso_tpu_torch.engine import Reverso
    from reverso_tpu_torch.models.pe import PerceptionEncoder

    cfg = default_config()
    model = dataclasses.replace(MODEL_PRESETS["test-tiny"], dtype="float32")
    cfg = dataclasses.replace(
        cfg, model=model, store=dataclasses.replace(cfg.store, root_dir=str(root)))
    encoder = encoder or PerceptionEncoder(model, device="cpu")
    return Reverso(cfg, encoder=encoder, detector=StubDetector(), device="cpu")


def _start(engine, create_server):
    srv = create_server(engine, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from reverso_tpu_torch.ui.server import create_server

    tmp = tmp_path_factory.mktemp("ui_torch")
    srv, base = _start(_port_engine(tmp / "db"), create_server)
    yield base, tmp
    srv.shutdown()


def test_about_reports_the_engine_device(server):
    base, _ = server
    about = get(base, "/api/about")
    assert about == {"name": "Reverso-TPU", "model": "test-tiny", "backend": "cpu"}


def test_search_endpoints_match_the_jax_server(tmp_path):
    """One store, served by both packages on the same fp32 weights: the
    direct-PE detect + search, a filtered search, recommend and discover
    return the same ids, filenames and scores."""
    from reverso_tpu.config import MODEL_PRESETS, default_config
    from reverso_tpu.detect import StubDetector
    from reverso_tpu.engine import Reverso
    from reverso_tpu.models.pe import PerceptionEncoder
    from reverso_tpu.ui.server import create_server as jax_server
    from reverso_tpu_torch.models.pe import PerceptionEncoder as TorchPE
    from reverso_tpu_torch.ui.server import create_server as torch_server

    model = dataclasses.replace(MODEL_PRESETS["test-tiny"], dtype="float32")
    jenc = PerceptionEncoder(model, seed=3)
    params = jax_tree_to_numpy(jenc.params)
    files = make_corpus(tmp_path / "imgs", n=6)
    engine_t = _port_engine(tmp_path / "db_t", TorchPE(model, params=params, device="cpu"))
    assert "ready for searching" in engine_t.create_database(
        str(tmp_path / "imgs"), "both", use_direct_pe=True)
    shutil.copytree(tmp_path / "db_t" / "both", tmp_path / "db_j" / "both")
    cfg = default_config()
    cfg = dataclasses.replace(cfg, model=model, store=dataclasses.replace(
        cfg.store, root_dir=str(tmp_path / "db_j")))
    engine_j = Reverso(cfg, encoder=jenc, detector=StubDetector())

    bodies = [("/api/query/search", {"threshold": -1.0, "max_results": 4}),
              ("/api/query/search", {"threshold": -1.0, "max_results": 4,
                                     "filter": {"must_not": [
                                         {"key": "filename", "match": {"value": "img_003.jpg"}}]}}),
              ("/api/query/recommend", {"positive": [1], "negative": [4],
                                        "max_results": 3, "threshold": -1.0}),
              ("/api/query/discover", {"target": 2, "pairs": [[1, 5]], "max_results": 3})]
    answers = []
    servers = []
    try:
        for engine, create in ((engine_j, jax_server), (engine_t, torch_server)):
            srv, base = _start(engine, create)
            servers.append(srv)
            assert post(base, "/api/db/load", {"name": "both"})[1]["message"].startswith("✅")
            code, det = post(base, "/api/query/detect",
                             {"image": img_b64(files[2]), "direct_pe": True})
            assert code == 200 and det["num_regions"] == 1
            out = []
            for path, body in bodies:
                code, r = post(base, path, dict(body, token=det["token"]))
                assert code == 200, r
                out.append([(it["id"], it["filename"], it["score"]) for it in r["results"]])
            answers.append(out)
    finally:
        for srv in servers:
            srv.shutdown()
    jax_out, torch_out = answers
    assert torch_out[0][0][1] == "img_002.jpg"
    assert all(len(r) > 0 for r in torch_out)
    assert "img_003.jpg" not in [f for _, f, _ in torch_out[1]]
    for want, got in zip(jax_out, torch_out):
        assert [(i, f) for i, f, _ in got] == [(i, f) for i, f, _ in want]
        np.testing.assert_allclose([s for *_, s in got], [s for *_, s in want],
                                   atol=SCORE_TOL, rtol=0)


def jax_tree_to_numpy(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
