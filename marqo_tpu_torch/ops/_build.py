"""Build the package's CUDA kernels at first use and load them with ctypes.

The sources in ``marqo_tpu_torch/csrc/`` have a plain C interface, so
``nvcc`` compiles them in seconds (no PyTorch headers): one ``nvcc -c`` per
``.cu`` file, all started together, then one link into a shared library.
The library goes to ``build/marqo_tpu_torch_kernels/`` beside the package,
named by a hash of the sources, headers and flags, so an edited source
rebuilds and an unchanged one is loaded as it is. A failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build" /
             "marqo_tpu_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of marqo_tpu_torch cannot be built")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmarqo_tpu_torch_kernels-{digest.hexdigest()[:16]}.so"


def _run_all(commands) -> None:
    """Run the commands in parallel; raise with the output of each that
    failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in commands]
    failures = []
    for cmd, proc in procs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): "
                            f"{' '.join(cmd)}\n{output}")
    if failures:
        raise RuntimeError("\n".join(failures))


def build() -> Path:
    """Compile the sources unless the library for them exists."""
    target = library_path()
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{target.name}.tmp{os.getpid()}"
    nvcc = _nvcc()
    objects = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in _sources()]
    try:
        _run_all([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                 for src, obj in zip(_sources(), objects))
        tmp = BUILD_DIR / stem
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objects)]])
        os.replace(tmp, target)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return target


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            # the attention kernels take their 12 element strides as a
            # host array of 64-bit ints
            strides = ctypes.POINTER(ctypes.c_longlong)
            # and the tile loop's code after them
            masked = lib.marqo_masked_attention
            masked.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
                ctypes.c_float, strides, ctypes.c_int, ctypes.c_void_p]
            masked.restype = ctypes.c_int
            causal = lib.marqo_masked_attention_causal
            causal.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
                ctypes.c_float, strides, ctypes.c_int, ctypes.c_void_p]
            causal.restype = ctypes.c_int
            fused = lib.marqo_fused_attention
            fused.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                ctypes.c_float, strides, ctypes.c_int, ctypes.c_void_p]
            fused.restype = ctypes.c_int
            w8a8 = lib.marqo_w8a8_matmul
            w8a8.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            w8a8.restype = ctypes.c_int
            _lib = lib
        return _lib
