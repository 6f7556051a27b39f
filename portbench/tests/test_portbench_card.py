"""On the card: each cell's run ends with a result line that is correct
(a short window). Skips without a CUDA device, decided in the fixture."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")


@pytest.mark.parametrize("workload", [
    "mad32k.movie.f32", "nlq.batch16x8.f32", "mad32k.movie.bf16",
    "nlq.batch16x8.bf16"])
def test_a_short_run_is_correct(card, workload):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "3141592653", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
