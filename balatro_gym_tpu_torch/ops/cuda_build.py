"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Kernels are compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C entry point, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library goes to ``build/kernels/``
at the repository root, named by a hash of the source, the headers of
``csrc/``, the flags and the compiler, so an edited source or header is
rebuilt and an unchanged one is reused.
Nothing is built until a kernel is first launched; ``load_all`` builds
several sources at once, one nvcc process each. ``sass_loop`` reads the
machine code of a kernel's main loop from a built library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = ROOT / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LOADED: dict = {}
build_log: dict = {}    # source name -> {"seconds": float, "ptxas": str, "cached": bool}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load(source: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<source>``, built on first use."""
    return load_all([source])[0]


def load_all(sources) -> list:
    """The libraries of several sources; those not yet built are compiled
    together, one nvcc process each. Loaded libraries return before any
    file is read: a launch calls this, and a filesystem lookup per launch
    would cost more than the kernel."""
    if all(s in _LOADED for s in sources):
        return [_LOADED[s] for s in sources]
    nvcc = nvcc_path()
    flags = ARCH_FLAGS + NVCC_FLAGS
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    t0 = time.perf_counter()
    jobs = {}
    for source in sources:
        if source in _LOADED:
            continue
        src = CSRC / source
        digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags + [nvcc]).encode())
        lib_path = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
        proc = tmp = None
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen([nvcc, *flags, "-o", str(tmp), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs[source] = (src, lib_path, tmp, proc)
    for source, (src, lib_path, tmp, proc) in jobs.items():
        ptxas = ""
        if proc is not None:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}\n{err}")
            ptxas = err
            os.replace(tmp, lib_path)
        _LOADED[source] = ctypes.CDLL(str(lib_path))
        build_log[source] = {"seconds": time.perf_counter() - t0, "ptxas": ptxas,
                             "cached": proc is None, "path": str(lib_path)}
    return [_LOADED[s] for s in sources]


def sass_loop(lib_path, kernel: str) -> list:
    """The opcodes of ``kernel``'s longest loop in the library at
    ``lib_path``, from ``cuobjdump -sass``: the body of its longest
    backward branch, the branch included, in address order."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    start = text.rfind("Function : ", 0, text.index(kernel))
    end = text.find("Function : ", start + 1)
    body = text[start:end if end > 0 else len(text)]
    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+((?:@!?U?P\w+\s+)?)([A-Z][A-Z0-9_.]*)([^;]*);",
                     body)
    loops = []
    for a, _, op, args in ins:
        m = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= int(a, 16):
            loops.append((int(a, 16) - int(m.group(1), 16), int(m.group(1), 16), int(a, 16)))
    if not loops:
        raise RuntimeError(f"no loop found in the SASS of {kernel}")
    _, lo, hi = max(loops)
    return [op.split(".")[0] for a, _, op, _ in ins if lo <= int(a, 16) <= hi]
