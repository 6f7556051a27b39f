"""Build, load and route to the port's hand-written CUDA kernels.

The kernels live in ``decafnet_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use each source is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a`` and the objects are linked into one
shared library under ``build/`` at the root of the checkout, in a directory
keyed by a hash of the sources and flags, then loaded with ``ctypes``.
Nothing is compiled or loaded when a module is imported, so the package
imports on machines without CUDA.

Routing rule shared by every kernel wrapper (:func:`use_kernel`): a tensor on
the CPU takes the op's plain PyTorch version; a CUDA tensor launches the
kernel or raises. The one exception is :func:`plain_versions`, a test hook
that lets a caller hold the kernels against their plain versions on the card.

Autograd rule shared by the kernel ops: when grad mode is on and an input
requires grad (:func:`recording`), the op runs as a
``torch.autograd.Function`` whose forward is the op's own (the kernel on the
card) and whose backward recomputes the forward through the plain version and
differentiates that (:func:`recompute_vjp`), as the JAX package's
``custom_vjp`` rules recompute through the XLA compositions. This is that
VJP's counterpart, not a fallback: on the card the forward is always the
kernel, and the backward is PyTorch because the JAX backward is XLA. The
kernels are forward-only; no backward launches one.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import glob
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB_NAME = "libdecafnet_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I", CSRC_DIR)

_vp, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the entry points (csrc/*.cu), all returning cudaError_t
_SIGNATURES = {
    "decafnet_conv3_ln_act_f32": [_vp] * 8 + [_i] * 4 + [_f, _i, _vp],
    "decafnet_qkv_depthwise_ln_f32": [_vp] * 14 + [_i] * 3 + [_f, _i, _vp],
    "decafnet_band_attention_f32": [_vp] * 5 + [_i] * 4 + [_ll] * 4 + [_i] * 3 + [_vp],
}


def sources():
    """The kernel sources, one nvcc process each."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers():
    """The headers the sources include (part of the build's hash)."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def toolkit_binary(name="nvcc"):
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", name) if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + headers():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], LIB_NAME)


def build_log(source):
    """What nvcc printed for one source (``-Xptxas=-v``: registers, shared
    memory and spills of each kernel), beside the built library."""
    with open(os.path.join(os.path.dirname(library_path()),
                           os.path.basename(source) + ".log")) as f:
        return f.read()


@contextlib.contextmanager
def _exclusive(directory):
    """Hold an exclusive lock on ``directory/.lock`` (``flock``): processes
    that build at once (the ranks of a ``torchrun`` job) take turns."""
    with open(os.path.join(directory, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build():
    """Compile the kernels if this source hash has no library yet.
    Returns (library path, seconds spent compiling; 0.0 when cached).
    Concurrent callers build once: the first takes the build directory's
    lock and compiles, the others wait for it and find the library."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    with _exclusive(out_dir):
        if os.path.exists(path):    # built while this process waited
            return path, 0.0
        return path, _compile(path, out_dir)


def _compile(path, out_dir):
    t0 = time.perf_counter()
    nvcc = toolkit_binary()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cus = sources()
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cus, objs)]
        failed = []
        for src, proc in zip(cus, procs):
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}:\n{log}")
            with open(os.path.join(out_dir, os.path.basename(src) + ".log"),
                      "w") as f:
                f.write(log)
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp_lib],
                       check=True, capture_output=True, text=True)
        os.replace(tmp_lib, path)
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def library():
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err, name):
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t):
    """Device pointer of a tensor (None passes a null pointer)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


class _Route(threading.local):
    plain = False


_ROUTE = _Route()


@contextlib.contextmanager
def plain_versions():
    """Test hook: inside this context CUDA tensors go through the ops' plain
    PyTorch versions instead of the kernels (the thread's own setting).
    Used to hold the kernels against their plain versions on the card; the
    default path never enters it."""
    prev = _ROUTE.plain
    _ROUTE.plain = True
    try:
        yield
    finally:
        _ROUTE.plain = prev


def use_kernel(x):
    """True when ``x`` must go through a CUDA kernel, False for the plain
    version (CPU tensors, or inside :func:`plain_versions`)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return not _ROUTE.plain


def recording(*tensors):
    """True when autograd must record a kernel op: grad mode is on and one of
    ``tensors`` (None entries allowed) requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def recompute_vjp(plain, args, needs, grad_outputs):
    """Gradients of ``plain(*args)`` for ``grad_outputs``: ``plain`` runs again
    under autograd on detached copies of the arguments whose ``needs`` flag
    is set and is differentiated by ``torch.autograd.grad``. Returns one
    entry per argument, None where ``needs`` is False (masks, absent
    parameters, options)."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() if need else a
                  for a, need in zip(args, needs)]
        outs = plain(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [leaf for leaf, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(outs, wrt, grad_outputs,
                                         allow_unused=True))
    return tuple(next(grads) if need else None for need in needs)


def require(cond, name, what):
    if not cond:
        raise ValueError(f"{name}: {what}")


@functools.lru_cache(maxsize=None)
def sm_count(device):
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def as_bytes(mask):
    """(B, T) bool mask as a contiguous uint8 view for the kernels."""
    return mask.contiguous().view(torch.uint8)


def time_tile(T, quantum, max_tile):
    """Time columns per block for a kernel that tiles T: the fewest tiles of
    at most ``max_tile`` columns, each as narrow as that allows, rounded up
    to a multiple of ``quantum`` and of 4 (16-byte copies). ``max_tile``
    must be such a multiple."""
    step = quantum * 4 // math.gcd(quantum, 4)
    assert max_tile % step == 0, (max_tile, step)
    per_tile = -(-T // -(-T // max_tile))
    return -(-per_tile // step) * step
