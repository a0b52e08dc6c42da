"""Without the cards a cell asks for, or without the program beside it,
a run exits with another code than 0 and prints no result."""
import os
import shutil
import subprocess
import sys

import pytest

from harness.cell import BENCH, ROOT


def run(cwd, *args, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run(ROOT, "--workload", "pe_l14.embed_b64", "--seed", str(2 ** 31 + 3),
              "--seconds", "1", "--trace", "0", env=env)
    assert out.returncode == 3, out.stderr[-2000:]
    assert out.stdout == ""
    assert "cuda" in out.stderr.lower()


def test_refuses_an_unknown_workload():
    out = run(ROOT, "--workload", "no.such_cell", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode == 2 and out.stdout == ""


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path, "--workload", "pe_l14.search_q256", "--seed", "5", "--seconds", "1",
              "--trace", "1")
    assert out.returncode != 0 and out.stdout == ""
    probe = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, 'benchmark'); "
         "from harness import program; print(program.outside_checkout())"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert probe.returncode == 0 and probe.stdout.strip() != "None"


@pytest.mark.parametrize("bad", [["--trace", "2"], ["--seed", "x"]])
def test_refuses_bad_arguments(bad):
    args = {"--workload": "pe_l14.embed_b64", "--seed": "1", "--seconds": "1", "--trace": "0"}
    args[bad[0]] = bad[1]
    out = run(ROOT, *[x for kv in args.items() for x in kv])
    assert out.returncode == 2 and out.stdout == ""
