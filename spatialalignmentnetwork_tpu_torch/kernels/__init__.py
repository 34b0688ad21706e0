"""Hand-written CUDA kernels: build at first use, ctypes binding, launch
counts.

Each source under `csrc/` is compiled by `nvcc` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), cached under `_build/` by the hash of its source, and loaded
with ctypes. Nothing is built or imported at module import: the CPU tests
import every module on machines without `nvcc` or a card.

`LAUNCHES` counts each kernel's launches (one per wrapper call that
launches it), so a caller can show that a path went through its kernels.
`on_card` picks the route for a tensor: its kernel on a CUDA tensor, its
plain PyTorch version on a CPU tensor, nothing else.
"""

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = collections.Counter()


def reset_launches():
    """Set every kernel's launch count to 0."""
    LAUNCHES.clear()


def on_card(t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def launch(name: str, launcher, like, *args):
    """Launch a kernel on the card of tensor `like`: inside
    `torch.cuda.device(like.device)`, call `launcher(*args, stream)` with
    that card's current stream, and pass its return code to
    `check_launch`. Every launch goes through here, so a kernel runs (and a
    C entry point reads its per-device state) on its tensors' card whatever
    the current device is."""
    import torch

    with torch.cuda.device(like.device):
        rc = launcher(*args, torch.cuda.current_stream().cuda_stream)
        check_launch(name, rc)


def check_f32_cuda(name: str, *tensors):
    """Raise unless every tensor is a contiguous float32 CUDA tensor, what
    the `name` kernels take."""
    import torch

    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the {name} kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel inputs must be contiguous")
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {t.device}")


def upstream(name: str, gout, like):
    """A loss's upstream gradient as the one contiguous float32 value the
    `name` backward kernels read on the device of `like`; raises otherwise."""
    if gout.numel() != 1 or gout.device != like.device:
        raise ValueError("the upstream gradient must be one value on the inputs' device")
    check_f32_cuda(name, gout.reshape(()))
    return gout.reshape(()).contiguous()


def check_launch(name: str, rc: int):
    """Raise on a launch's cudaError; else count the launch under `name`."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from csrc/ at first use"
    )


def build(source: str) -> tuple:
    """Compile `csrc/<source>` into `_build/` unless a library built from
    the same source text is there. Returns (library path, compiler log);
    the log is empty when the cached library was reused."""
    src = os.path.join(CSRC, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    lib = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, proc.stdout + proc.stderr


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library."""
    return ctypes.CDLL(build(source)[0])
