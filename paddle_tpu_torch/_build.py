"""Build and bind the port's CUDA kernels: ``nvcc`` by hand into one
shared library per source with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).

Libraries go to ``paddle_tpu_torch/build/`` (git-ignored), named by a
hash of the source and the compiler flags, and are built at first use:
running ``python3 chip_smoke.py`` from a fresh checkout builds them.
Only sources under ``paddle_tpu_torch/csrc/`` are compiled. Importing
this module starts nothing; ``nvcc`` runs only inside :func:`build`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["SOURCES", "BUILD_DIR", "nvcc_path", "nvcc_command",
           "library_path", "build", "load", "build_logs"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# kernel name -> its source under csrc/ (one library per source, so the
# sources build in parallel, one nvcc each)
SOURCES = {"paged_decode": "paged_decode.cu",
           "flash_attention": "flash_attention.cu",
           "flash_segment": "flash_segment.cu",
           "flash_bhsd": "flash_bhsd.cu",
           "fused_adam": "fused_adam.cu",
           "megastep_loop": "megastep_loop.cu"}

# sm_90a, not sm_90: wgmma/setmaxnreg exist only for the "a" target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs = {}
build_logs = {}   # name -> nvcc's output of the last build (ptxas -v)


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    the toolkit's default install location; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are compiled from paddle_tpu_torch/csrc at first use")


def _source(name):
    if name not in SOURCES:
        raise KeyError("unknown kernel source %r (known: %s)"
                       % (name, ", ".join(sorted(SOURCES))))
    return os.path.join(CSRC_DIR, SOURCES[name])


def library_path(name):
    """Where ``name``'s library lives: keyed by a hash of its source, the
    headers under csrc/ and the compiler flags, so an edited source never
    loads a stale build."""
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [_source(name)] + [os.path.join(CSRC_DIR, f)
                                   for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, h.hexdigest()[:16]))


def nvcc_command(name, out_path, nvcc="nvcc"):
    return [nvcc, *NVCC_FLAGS, "-o", out_path, _source(name)]


def build(names=None):
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns the build's wall seconds;
    raises with nvcc's output if any compile fails."""
    names = sorted(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.isfile(library_path(n))]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = "%s.tmp%d" % (out, os.getpid())
        procs.append((n, out, tmp, subprocess.Popen(
            nvcc_command(n, tmp, nvcc), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        build_logs[n] = log
        if p.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append("%s (nvcc exit %d):\n%s" % (n, p.returncode, log))
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name):
    """The ctypes handle of ``name``'s library, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib
