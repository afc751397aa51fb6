"""Build the sources of ``csrc/`` into shared libraries with a plain C
interface, loaded with ctypes: the CUDA kernels (``.cu``) with nvcc,
the native CPU simulator (``.cpp``) with g++ (``build_host``).

Libraries go to ``traffic_env_tpu_torch/_build/`` under a name that
hashes the source and the flags, so a changed source rebuilds and an
unchanged one loads at once.  Nothing is built at import time: the first
launch of a kernel, or the first native simulator, builds it.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# every float32 op IEEE and un-fused, as the oracle's
HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-fno-fast-math",
              "-ffp-contract=off")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(src: pathlib.Path, flags, headers=()) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in headers:
        h.update(hdr.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _compile(cmd_head: list, src: pathlib.Path, target: pathlib.Path,
             tool: str) -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if target.exists():
        return {"path": str(target), "seconds": 0.0, "log": ""}
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd_head, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} failed for {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)
    return {"path": str(target), "seconds": seconds, "log": proc.stdout}


def build(name: str) -> dict:
    """Build ``csrc/<name>.cu`` with one nvcc call unless it is built
    already.  Returns {"path", "seconds", "log"}; ``log`` holds nvcc's
    output (ptxas register and spill counts) when this call built the
    library and is empty when it was built already."""
    src = CSRC / f"{name}.cu"
    return _compile([nvcc_path(), *NVCC_FLAGS], src,
                    _target(src, NVCC_FLAGS, sorted(CSRC.glob("*.cuh"))),
                    "nvcc")


def build_host(name: str) -> dict:
    """Build the host C++ source ``csrc/<name>.cpp`` with one g++ call
    (``HOST_FLAGS``) unless it is built already; returns what
    :func:`build` returns.  Raises when g++ is missing or fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native simulator is built "
                           "with g++")
    src = CSRC / f"{name}.cpp"
    return _compile([gxx, *HOST_FLAGS], src, _target(src, HOST_FLAGS),
                    "g++")


def _kernel_name(mangled: str) -> str:
    """``name<flag,...>`` for a kernel template on bool flags, else the
    mangled name."""
    m = re.match(r"_Z\d+(\w+?)I((?:Lb[01]E)+)E", mangled)
    if not m:
        return mangled
    flags = ",".join("true" if f == "1" else "false"
                     for f in re.findall(r"Lb([01])E", m.group(2)))
    return f"{m.group(1)}<{flags}>"


def ptxas_usage(log: str) -> list[dict]:
    """Registers, stack and spill bytes per kernel from ptxas -v output."""
    rows = []
    for m in re.finditer(
            r"Function properties for (\S+)\s*\n\s*"
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
            r"(\d+) bytes spill loads\s*\n[^\n]*Used (\d+) registers", log):
        rows.append({"kernel": _kernel_name(m.group(1)),
                     "stack_bytes": int(m.group(2)),
                     "spill_store_bytes": int(m.group(3)),
                     "spill_load_bytes": int(m.group(4)),
                     "registers": int(m.group(5))})
    return rows
