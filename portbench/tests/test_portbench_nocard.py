"""A run that finds no card exits non-zero and prints no result."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_run_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for workload in ("nlq.batch16x8.f32", "mad32k.movie.f32"):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", workload,
             "--seed", "4000000001", "--seconds", "1", "--trace", "0"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert out.stdout == ""
        assert "no CUDA device" in out.stderr
