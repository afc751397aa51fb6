"""Build the CUDA sources of ``csrc/`` with nvcc into shared libraries
with a plain C interface, loaded with ctypes.

Libraries go to ``traffic_env_tpu_torch/_build/`` under a name that
hashes the source and the flags, so a changed source rebuilds and an
unchanged one loads at once.  Nothing is built at import time: the first
launch of a kernel builds it.
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


def _target(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Build ``csrc/<name>.cu`` with one nvcc call unless it is built
    already.  Returns {"path", "seconds", "log"}; ``log`` holds nvcc's
    output (ptxas register and spill counts) when this call built the
    library and is empty when it was built already."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = _target(name)
    if target.exists():
        return {"path": str(target), "seconds": 0.0, "log": ""}
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)
    return {"path": str(target), "seconds": seconds, "log": proc.stdout}


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
