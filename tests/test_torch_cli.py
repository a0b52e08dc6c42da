"""The `reverso-torch` command (`reverso_tpu_torch.cli`) against the JAX
package's `reverso` command, on the CPU.

Each case runs the same argv through `reverso_tpu.cli.main` and
`reverso_tpu_torch.cli.main` (with `--device cpu`) on copies of one store,
with the same fp32 vision and text weights (msgpack files both packages
read, through `REVERSO_PE_CKPT` and `REVERSO_CLIP_TEXT_CKPT`), and holds
their exit codes and standard output against each other: JSON parsed and
compared value by value, floats to `FLOAT_TOL`, text line by line, the
store root written as `<root>`. Two kinds of field are listed by name and
not compared: those that hold times (`TIME_KEYS`) and the uuid4 region ids
each package draws for the rows it writes (`UUID_KEYS`). After the
commands, the two stores' rows and payloads are compared too.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

from test_pipeline import make_corpus
from test_torch_cliptext import write_bpe

FLOAT_TOL = 1e-5          # both towers in fp32; scans in fp32 over bf16 rows
# tune's sweep (host times) and `info`'s write stamp (time_ns at the write)
TIME_KEYS = {"ms_per_batch", "data_version"}
UUID_KEYS = {"region_id", "original_region_id"}   # uuid4 per written row


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Images, the weight files and the base store (built by the port's
    `build`), shared by every case."""
    import jax

    from reverso_tpu.config import MODEL_PRESETS
    from reverso_tpu.models.pe import PerceptionEncoder
    from reverso_tpu_torch.detect.clipbpe import ClipBPETokenizer
    from reverso_tpu_torch.models.checkpoint import save_params
    from reverso_tpu_torch.models.cliptext import ClipTextConfig, TextEmbedder
    from reverso_tpu_torch.models.convert import flax_params_from_text

    tmp = tmp_path_factory.mktemp("cli")
    make_corpus(tmp / "imgs", n=6)
    model = dataclasses.replace(MODEL_PRESETS["test-tiny"], dtype="float32")
    pe = PerceptionEncoder(model, seed=1)
    save_params(str(tmp / "pe.msgpack"), jax.tree_util.tree_map(np.asarray, pe.params),
                meta={"config": dataclasses.asdict(model), "family": "pe"})
    vocab, merges = write_bpe(tmp)
    bpe = ClipBPETokenizer(vocab, merges, context_length=12)
    tcfg = ClipTextConfig(vocab_size=len(bpe.encoder), width=32, depth=1, num_heads=2,
                          context_length=12, embed_dim=model.embed_dim,
                          eot_token_id=bpe.eot)
    text = TextEmbedder(tcfg, None, bpe, device="cpu", seed=2)
    save_params(str(tmp / "text.msgpack"), flax_params_from_text(text.module.state_dict()),
                meta={"config": dataclasses.asdict(tcfg)})
    env = {"REVERSO_PE_CKPT": str(tmp / "pe.msgpack"),
           "REVERSO_CLIP_TEXT_CKPT": str(tmp / "text.msgpack"),
           "REVERSO_CLIP_VOCAB": vocab, "REVERSO_CLIP_MERGES": merges,
           "REVERSO_JAX_CACHE": str(tmp / "jax_cache")}

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        from reverso_tpu_torch import cli
        assert cli.main(["--device", "cpu", "--db-root", str(tmp / "base"), "build",
                         str(tmp / "imgs"), "--name", "cli", "--direct-pe"]) == 0
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return tmp, env


def npz(path, **arrays):
    np.savez(path, **arrays)
    return str(path)


def cases(tmp, own):
    """name -> list of argvs, run in order (`{root}` is each package's
    store root; `tmp` holds the shared assets, `own` the case's files)."""
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((2, 32)).astype(np.float32)
    upsert = npz(tmp / "upsert.npz", vectors=vecs,
                 payloads=np.array([json.dumps({"filename": f"ext_{i}.jpg", "tag": i})
                                    for i in range(2)]))
    update = npz(tmp / "update.npz", ids=np.array([0]), vectors=vecs[:1])
    batch = tmp / "batch.json"
    batch.write_text(json.dumps([
        {"set_payload": {"payload": {"seen": True}, "points": [0, 1]}},
        {"delete_payload": {"keys": ["seen"], "points": [1]}},
        {"update_vectors": {"points": [2], "vectors": vecs[1:].tolist()}},
        {"delete": {"points": [5]}}]))
    img = str(tmp / "imgs" / "img_002.jpg")
    return {
        "build": [["build", str(tmp / "imgs"), "--name", "fresh", "--direct-pe"]],
        "search": [["search", img, "--name", "cli", "--json", "--threshold", "-1",
                    "--top-k", "4"]],
        "search_filtered": [["search", img, "--name", "cli", "--json", "--threshold", "-1",
                             "--filter", "detected_class=full_image",
                             "--filter", "filename!=img_002.jpg"]],
        "search_text": [["search-text", "a cat", "--name", "cli", "--json",
                         "--threshold", "-1", "--top-k", "3"]],
        "recommend": [["recommend", "--name", "cli", "--positive", "1", "--negative", "4",
                       "--json", "--threshold", "-1"]],
        "discover": [["discover", "--name", "cli", "--target", "2", "--pair", "1:5",
                      "--json"]],
        "query": [["query", "cli", "--prefetch", "1", "--prefetch", "3", "--fusion", "rrf",
                   "--top-k", "3", "--json"],
                  ["query", "cli", "--target", "2", "--top-k", "3", "--json"]],
        "matrix": [["matrix", "cli", "--sample", "4", "--limit", "2", "--seed", "0",
                    "--json"]],
        "points": [["points", "cli", "--limit", "3", "--json"],
                   ["points", "cli", "--offset", "3", "--limit", "2", "--vectors", "--json"]],
        "facet": [["facet", "cli", "filename", "--json"]],
        "get": [["get", "cli", "0", "2", "--vectors", "--json"]],
        "payload": [["payload", "cli", "set", "--kv", "tag=7", "--points", "0", "1"],
                    ["payload", "cli", "delete", "--keys", "tag", "--points", "1"],
                    ["points", "cli", "--limit", "2", "--json"]],
        "batch": [["batch", "cli", str(batch)], ["points", "cli", "--json"]],
        "upsert": [["upsert", "cli", upsert], ["upsert", "fromnpz", upsert],
                   ["info", "fromnpz", "--json"]],
        "update_vectors": [["update-vectors", "cli", update],
                           ["get", "cli", "0", "--vectors", "--json"]],
        "delete_vectors": [["delete-vectors", "cli", "--ids", "1"],
                           ["search", img, "--name", "cli", "--json", "--threshold", "-1"]],
        "index_payload": [["index-payload", "cli", "filename", "--text"]],
        "alias": [["alias", "set", "al", "cli"], ["alias", "list"],
                  ["recommend", "--name", "al", "--positive", "0", "--json",
                   "--threshold", "-1"], ["alias", "delete", "al"]],
        "list": [["list"]],
        "info": [["info", "cli", "--json", "--classes",
                  "--filter", "filename=img_001.jpg"]],
        "export": [["export", "cli", "{root}/cli.snap"]],
        "import": [["export", "cli", "{root}/cli.snap"],
                   ["import", "{root}/cli.snap", "--name", "restored"],
                   ["info", "restored", "--json"]],
        "prune": [["prune", "cli", "--filter", "filename=img_005.jpg", "--dry-run"],
                  ["prune", "cli", "--filter", "filename=img_005.jpg"],
                  ["prune", "cli", "--ids", "0"], ["info", "cli", "--json"]],
        "unlock": [["unlock", "cli"]],
        "delete": [["delete", "cli"], ["list"], ["delete", "cli"]],
        "tune": [["tune", "--name", "cli", "--queries", "6", "--k", "3"]],
        "video_local": [["video", "local", str(own / "vids"), "{root}/frames"]],
    }


CASES = ["build", "search", "search_filtered", "search_text", "recommend", "discover",
         "query", "matrix", "points", "facet", "get", "payload", "batch", "upsert",
         "update_vectors", "delete_vectors", "index_payload", "alias", "list", "info",
         "export", "import", "prune", "unlock", "delete", "tune", "video_local"]


def parse(out: str, root: str):
    out = out.replace(root, "<root>")
    try:
        return json.loads(out)
    except ValueError:
        return out.splitlines()


def assert_same(got, want, where="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, got, want)
        for k in want:
            if k not in TIME_KEYS | UUID_KEYS:
                assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)) and abs(got - want) <= FLOAT_TOL, \
            (where, got, want)
    else:
        assert got == want, (where, got, want)


def run(main, argv, root, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, parse(capsys.readouterr().out, root)


@pytest.mark.parametrize("case", CASES)
def test_cli_matches_jax(case, assets, tmp_path, monkeypatch, capsys):
    from reverso_tpu import cli as jax_cli
    from reverso_tpu_torch import cli as torch_cli
    from reverso_tpu_torch.store import VectorStore

    tmp, env = assets
    if case == "video_local":
        pytest.importorskip("cv2")
        from test_video import write_clip
        (tmp_path / "vids").mkdir()
        write_clip(tmp_path / "vids" / "a.avi", scenes=2, frames_per_scene=12)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    roots = {}
    for pkg in ("jax", "torch"):
        roots[pkg] = str(tmp_path / pkg)
        shutil.copytree(tmp / "base", roots[pkg])
    for argv in cases(tmp, tmp_path)[case]:
        outs = {}
        for pkg, main, extra in (("jax", jax_cli.main, []),
                                 ("torch", torch_cli.main, ["--device", "cpu"])):
            root = roots[pkg]
            args = extra + ["--db-root", root] + [a.replace("{root}", root) for a in argv]
            outs[pkg] = run(main, args, root, capsys)
        assert outs["torch"][0] == outs["jax"][0], (argv, outs)
        assert_same(outs["torch"][1], outs["jax"][1], f"{argv[0]}")
    # the stores the two commands left behind
    names = sorted(n for n in os.listdir(roots["jax"])
                   if os.path.isfile(os.path.join(roots["jax"], n, "meta.json")))
    assert names == sorted(n for n in os.listdir(roots["torch"])
                           if os.path.isfile(os.path.join(roots["torch"], n, "meta.json")))
    for name in names:
        a = VectorStore.open(roots["jax"], name)
        b = VectorStore.open(roots["torch"], name)
        assert b.count == a.count
        np.testing.assert_allclose(np.asarray(b.vectors()), np.asarray(a.vectors()),
                                   atol=FLOAT_TOL, rtol=0)
        assert_same(b.payloads(), a.payloads(), name)
    if case == "video_local":
        assert sorted(os.listdir(os.path.join(roots["torch"], "frames"))) == \
            sorted(os.listdir(os.path.join(roots["jax"], "frames")))


def test_parsers_take_the_same_commands_and_options():
    """Every subcommand and option string of the JAX parser, with the same
    choices and defaults; the port adds only `--device`."""
    from reverso_tpu import cli as jax_cli
    from reverso_tpu_torch import cli as torch_cli

    def shape(parser):
        out = {}
        for action in parser._actions:
            if action.choices is not None and hasattr(action, "_name_parser_map"):
                for name, sub in action._name_parser_map.items():
                    out.update({f"{name} {k}": v for k, v in shape(sub).items()})
            else:
                for opt in action.option_strings or [action.dest]:
                    out[opt] = (action.default, tuple(action.choices or ()),
                                action.nargs, action.required)
        return out

    jax_shape = shape(jax_cli.build_parser())
    torch_shape = shape(torch_cli.build_parser())
    assert torch_shape.pop("--device") == ("cuda", (), None, False)
    assert torch_shape == jax_shape


@pytest.mark.parametrize("argv,item", [
    (["bench"], "item 8"),
])
def test_unported_commands_name_their_item(argv, item, capsys, monkeypatch):
    """`bench` exits non-zero and names its ROADMAP item; it does not start
    `bench.py` (it drives the JAX package)."""
    import subprocess

    from reverso_tpu_torch import cli

    monkeypatch.setattr(subprocess, "call", lambda *a, **k: pytest.fail("started a process"))
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: pytest.fail("started a process"))
    assert cli.main(["--device", "cpu"] + argv) != 0
    err = capsys.readouterr().err
    assert "ROADMAP" in err and item in err


def test_train_runs_checkpoints_and_resumes(tmp_path, capsys):
    """`reverso-torch --device cpu train` at test-tiny on six seeded images:
    two steps of batch 4 (a full batch, then the short last one) with a
    checkpoint, then `--resume` for one more. The JAX command's lines: on
    stderr "step i/n loss x" and "saved checkpoint to <path>", "resumed at
    step N" after a resume; on stdout "final loss x"."""
    import re

    from reverso_tpu_torch import cli
    from reverso_tpu_torch.train.checkpoint import restore_train_state
    from reverso_tpu_torch.train import ClipTrainer
    from reverso_tpu_torch.config import MODEL_PRESETS

    make_corpus(tmp_path / "imgs", n=6)
    ckpt = str(tmp_path / "ckpt" / "state.pt")
    base = ["--device", "cpu", "--model", "test-tiny", "train", str(tmp_path / "imgs"),
            "--batch-size", "4", "--lr", "1e-3", "--checkpoint", ckpt]
    assert cli.main(base + ["--steps", "2"]) == 0
    out, err = capsys.readouterr()
    assert re.fullmatch(r"final loss \d+\.\d{4}\n", out), out
    assert re.search(r"^step 2/2 loss \d+\.\d{4}$", err, re.M), err
    assert f"saved checkpoint to {ckpt}" in err and "resumed" not in err
    template = ClipTrainer(MODEL_PRESETS["test-tiny"], device="cpu").state
    assert int(restore_train_state(ckpt, template).step) == 2
    assert cli.main(base + ["--steps", "1", "--resume"]) == 0
    out, err = capsys.readouterr()
    assert err.splitlines()[0] == "resumed at step 2", err
    assert re.search(r"^step 1/1 loss \d+\.\d{4}$", err, re.M), err
    assert re.fullmatch(r"final loss \d+\.\d{4}\n", out), out
    assert int(restore_train_state(ckpt, template).step) == 3


def test_train_tensor_parallel_names_item_21(tmp_path, capsys):
    """`train --device cpu --tp 2` (the name is kept from when it named
    ROADMAP item 21b): a 1 x 2 mesh of the CPU trains two steps with a
    checkpoint and resumes onto the same mesh; `--tp 3` does not divide
    test-tiny's 4 heads and exits non-zero, naming both."""
    import re

    from reverso_tpu_torch import cli
    from reverso_tpu_torch.config import MODEL_PRESETS
    from reverso_tpu_torch.train import ClipTrainer
    from reverso_tpu_torch.train.checkpoint import restore_train_state

    make_corpus(tmp_path / "imgs", n=6)
    ckpt = str(tmp_path / "ckpt" / "state.pt")
    base = ["--device", "cpu", "--model", "test-tiny", "train", str(tmp_path / "imgs"),
            "--batch-size", "4", "--lr", "1e-3", "--checkpoint", ckpt, "--tp", "2"]
    assert cli.main(base + ["--steps", "2"]) == 0
    out, err = capsys.readouterr()
    assert re.fullmatch(r"final loss \d+\.\d{4}\n", out), out
    assert re.search(r"^step 2/2 loss \d+\.\d{4}$", err, re.M), err
    assert cli.main(base + ["--steps", "1", "--resume"]) == 0
    out, err = capsys.readouterr()
    assert err.splitlines()[0] == "resumed at step 2", err
    assert re.fullmatch(r"final loss \d+\.\d{4}\n", out), out
    template = ClipTrainer(MODEL_PRESETS["test-tiny"], device="cpu").state
    assert int(restore_train_state(ckpt, template).step) == 3
    assert cli.main(base[:-1] + ["3", "--steps", "1"]) != 0
    err = capsys.readouterr().err
    assert "3 shards" in err and "4 heads" in err and "ROADMAP" not in err, err
