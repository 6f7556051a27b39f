"""What the benchmark loads: nothing of JAX or the JAX package, compared by
whole top-level module names (``decafnet_tpu_torch`` starts with
``decafnet_tpu``); the reference nothing of the port either."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "decafnet_tpu"}


def loaded_after(code):
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    interpreter (JAX kept off any device)."""
    script = (f"import sys; sys.path.insert(0, {ROOT!r})\n{code}\n"
              "import json; print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_imports_no_jax():
    code = """
import glob, os, runpy
import portbench.harness, portbench.calibrate
from portbench import harness
from decafnet_tpu_torch.serve import GroundingService
from decafnet_tpu_torch.core import CfgNode
for path in glob.glob(os.path.join(harness.HERE, "metrics", "*.py")):
    harness.reader(os.path.basename(path)[:-3])
runpy.run_path(os.path.join(harness.HERE, "run.py"), run_name="portbench_run")
"""
    names = loaded_after(code)
    assert "decafnet_tpu_torch" in names and "torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    code = """
import portbench.reference.decode, portbench.reference.model
import portbench.reference.weights
"""
    names = loaded_after(code)
    assert "torch" in names
    assert "decafnet_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_harness_names_loaded_jax(monkeypatch):
    from portbench import harness
    import types
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "decafnet_tpu_torchy", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["jaxlib"]
