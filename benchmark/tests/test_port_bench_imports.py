"""No run may load JAX or the JAX package: the check compares each loaded
module's top-level name whole, so the port (whose name begins with the
JAX package's) passes."""
import os
import subprocess
import sys
import types

from harness import device
from harness.cell import BENCH, ROOT


def test_top_level_names_compared_whole(monkeypatch):
    for name in ("reverso_tpu_torch", "reverso_tpu_torch.models", "jaxtyping", "flaxen",
                 "reverso_tpu_torchx"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    for name in ("jax", "jaxlib.xla", "flax.linen", "reverso_tpu", "reverso_tpu.ops"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert device.forbidden_modules() == []
    for name in ("reverso_tpu.ops", "jaxlib.xla", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert device.forbidden_modules() == ["flax", "jaxlib.xla", "reverso_tpu.ops"]


def test_the_harness_and_the_port_load_no_jax():
    """Every file a run can load, in a fresh process."""
    code = f"""
import glob, os, sys
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
from harness import cell, device, program, readers, trace, weights
from reference import search, train, vit
for path in sorted(glob.glob(os.path.join({BENCH!r}, "entries", "*.py"))
                   + glob.glob(os.path.join({BENCH!r}, "metrics", "*.py"))):
    cell.load_module(path, "m_" + os.path.basename(path)[:-3].replace(".", "_"))
import reverso_tpu_torch.models.pe, reverso_tpu_torch.store.index, reverso_tpu_torch.train.clip
print(device.forbidden_modules())
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
