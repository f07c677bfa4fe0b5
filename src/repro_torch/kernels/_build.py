"""Build the CUDA sources under ``src/repro_torch/csrc/`` into one shared
library at first use and load it with ``ctypes``.

Every ``*.cu`` file compiles in its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects link into one ``.so`` with a plain
C interface (no PyTorch headers, so a build takes seconds, not minutes).
The library is named by a hash of the sources and the flags and is
written atomically (temporary name, then ``os.replace``), so parallel
processes that build at once never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]
LINK_FLAGS = ARCH_FLAGS + ["-shared"]

_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took in this process (0.0 when the library
#: was already on disk) and the compiler's messages (``-Xptxas -v``
#: register / shared-memory report)
build_seconds = 0.0
build_log = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on the machine with the card (set CUDA_HOME)")


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds, tmp: Path):
    """Run the commands together, each writing to its own log file; wait
    for all of them, then raise on the first that failed.  Each log ends
    with the seconds its command took (a build's critical path)."""
    t0 = time.perf_counter()
    logs = [tmp / f"cmd{i}.log" for i in range(len(cmds))]
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f,
                                          stderr=subprocess.STDOUT))
    seconds = [None] * len(procs)
    while None in seconds:
        for i, p in enumerate(procs):
            if seconds[i] is None and p.poll() is not None:
                seconds[i] = time.perf_counter() - t0
        time.sleep(0.05)
    out = []
    for cmd, p, log, sec in zip(cmds, procs, logs, seconds):
        text = log.read_text()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{text}")
        out.append(f"{text}[build] {Path(cmd[-1]).name}: {sec:.1f} s\n")
    return "".join(out)


def build() -> Path:
    """Compile and link the library unless it is already on disk."""
    global build_seconds, build_log
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp-"))
    try:
        cus = [p for p in _sources() if p.suffix == ".cu"]
        objs = [tmp / (p.stem + ".o") for p in cus]
        log = _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(p), "-o", str(o)]
                        for p, o in zip(cus, objs)], tmp)
        so = tmp / target.name
        log += _run_all([[nvcc, *LINK_FLAGS, *map(str, objs),
                          "-o", str(so)]], tmp)
        os.replace(so, target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    build_log = log
    return target


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def entry(name: str, argtypes) -> ctypes._CFuncPtr:
    """One C entry point with its ``argtypes`` set (pointers and the
    stream as ``c_void_p``) and an ``int`` return: the
    ``cudaGetLastError()`` after the launch."""
    fn = getattr(load(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


#: torch dtype -> the type code the C entry points take (csrc/common.cuh
#: DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.int32: 3}


def dtype_code(dtype: torch.dtype, what: str) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {dtype} not supported by the CUDA "
                        "kernels (float32, bfloat16, int8 or int32)")
    return DTYPE_CODES[dtype]


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s card."""
    return torch.cuda.current_stream(t.device).cuda_stream


def copy_mode(t: Optional[torch.Tensor], ld: int, tile_cols: int) -> int:
    """How a kernel that stages through ``csrc/staging.cuh`` (B6, B7)
    copies an operand into shared memory: 2 = 16-byte ``cp.async``
    (base, row stride and tile width on 16 bytes), 1 = 4-byte
    ``cp.async``, 0 = plain loads."""
    if t is None:
        return 0
    es = t.element_size()
    for mode, unit in ((2, 16), (1, 4)):
        if t.data_ptr() % unit == 0 and (ld * es) % unit == 0 \
                and (tile_cols * es) % unit == 0:
            return mode
    return 0


def ptr(t: Optional[torch.Tensor]):
    """A tensor's device address for a C entry point, None for none."""
    return t.data_ptr() if t is not None else None


def require_meta(name: str, *tensors) -> None:
    """Every operand (None skipped) on the meta device, where a dry-run
    traces shapes and nothing launches; a mix raises."""
    for t in tensors:
        if t is not None and t.device.type != "meta":
            raise ValueError(f"{name}: a meta trace needs every operand on "
                             f"the meta device, got one on {t.device}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every operand on one CUDA device; anything else raises."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: operands must share one CUDA "
                             f"device, got {t.device} and {dev}")


def check(rc: int, name: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if rc != 0:
        fn = load().repro_cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           f"({fn(rc).decode()})")
