"""Concurrent first use of the kernel build (``ops/cuda.py`` ``build``), as
the ranks of a ``torchrun`` job meet it: several processes calling
``build()`` at once compile once. A stand-in ``nvcc`` (a script that
records its call, waits and writes its output) takes the toolkit's place,
so the rule is tested without CUDA: one process compiles, the others wait
for the lock and find the library, every log lands whole, and no
temporary file is left behind."""

import json
import os
import stat
import subprocess
import sys
import textwrap

import torch

from decafnet_tpu_torch.ops import cuda

# one intra-op thread per test process: the suite runs several processes
# side by side, and torch's default (one thread per core) in each of them
# oversubscribes the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = textwrap.dedent("""
    import os, sys, time
    with open(os.environ["NVCC_CALLS"], "a") as f:
        f.write(" ".join(sys.argv[1:]) + "\\n")
    time.sleep(0.5)
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(out, "w") as f:
        f.write("object")
    print("ptxas info    : whole log of " + os.path.basename(out) + " " + "x" * 4096)
""")

BUILDER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    from decafnet_tpu_torch.ops import cuda
    cuda.BUILD_DIR = sys.argv[2]
    cuda.toolkit_binary = lambda name="nvcc": sys.argv[3]
    path, seconds = cuda.build()
    print("BUILD::" + json.dumps({"path": path, "compiled": seconds > 0}))
""")


def test_concurrent_builds_compile_once(tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    builder = tmp_path / "builder.py"
    builder.write_text(BUILDER)
    calls = tmp_path / "calls.txt"
    env = dict(os.environ, NVCC_CALLS=str(calls))
    procs = [subprocess.Popen([sys.executable, str(builder), REPO,
                               str(tmp_path / "build"), str(nvcc)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for _ in range(3)]
    results = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out[-3000:]
        results.append(json.loads(next(l for l in out.splitlines()
                                       if l.startswith("BUILD::"))[7:]))

    assert len({r["path"] for r in results}) == 1
    assert sorted(r["compiled"] for r in results) == [False, False, True]
    n_src = len(cuda.sources())
    lines = calls.read_text().splitlines()
    assert len(lines) == n_src + 1 and sum("-shared" in l for l in lines) == 1
    out_dir = os.path.dirname(results[0]["path"])
    assert os.path.exists(results[0]["path"])
    for src in cuda.sources():
        name = os.path.basename(src)
        with open(os.path.join(out_dir, name + ".log")) as f:
            log = f.read()
        assert log.startswith("ptxas info") and log.endswith("x" * 4096 + "\n")
    leftovers = [f for f in os.listdir(out_dir)
                 if f.endswith(".tmp") or os.path.isdir(os.path.join(out_dir, f))]
    assert not leftovers, leftovers
