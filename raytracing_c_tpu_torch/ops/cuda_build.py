"""One build and one launch path for every CUDA kernel of the package.

Each `csrc/*.cu` compiles with nvcc into a shared library of its own with a
plain C interface (`lib<stem>.so`), all nvcc processes started together,
into `raytracing_c_tpu_torch/_build/<hash>/`. The hash covers every source
and the flags, so editing any source rebuilds them all. Wrappers load their
library with `library(stem)` through ctypes. A failed build raises.

Every kernel launch goes through `launch`, which picks the device and its
stream, raises on a failed launch and counts it by kernel name;
`launch_counts()` and `reset_launch_counts()` read and zero the counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot build")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def build_libraries() -> dict:
    """Compile every csrc/*.cu unless a build of the same sources and flags
    exists. Returns dict(dir, seconds, libraries={stem: path}); seconds is
    0.0 when the build was already there."""
    out_dir = BUILD_DIR / build_key()
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in sources()}
    if all(p.exists() for p in libs.values()):
        return {"dir": out_dir, "seconds": 0.0, "libraries": libs}
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, tmp, cmd, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}{err}")
        else:
            os.replace(tmp, libs[src.stem])
    if errors:
        raise RuntimeError("\n".join(errors))
    return {"dir": out_dir, "seconds": time.perf_counter() - t0, "libraries": libs}


def library(stem: str) -> ctypes.CDLL:
    """The library built from csrc/<stem>.cu, loaded (builds all at first
    use). Each wrapper module loads its library once and declares its
    functions' argtypes."""
    return ctypes.CDLL(str(build_libraries()["libraries"][stem]))


#: launches since the last reset, by kernel: K1's one-thread and eight-lane
#: kernels, K2, K3, K4 and its NEE add, and K5's four draws
_COUNTS = dict.fromkeys(
    ("bvh_traverse", "bvh_traverse_wide", "fetch_attrs", "denoise_u8", "shade_bounce",
     "nee_add", "rng_fold_in", "rng_split", "rng_bits", "rng_bounce_uniforms"), 0)


def launch(name: str, entry, *args, device) -> None:
    """entry(*args, stream): one launch of kernel `name` through its
    library's C entry, on `device`'s current stream whichever device is
    current. Raises on a non-zero return; counts the launch under `name`."""
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    _COUNTS[name] += 1


def launch_counts() -> dict:
    """Every kernel's launches since the last `reset_launch_counts`."""
    return dict(_COUNTS)


def reset_launch_counts() -> None:
    for name in _COUNTS:
        _COUNTS[name] = 0
