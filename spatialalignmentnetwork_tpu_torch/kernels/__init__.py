"""Hand-written CUDA kernels: build at first use, ctypes binding, launch
counts.

Each source under `csrc/` is compiled by `nvcc` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), cached under `_build/` by the hash of its source, and loaded
with ctypes. Nothing is built or imported at module import: the CPU tests
import every module on machines without `nvcc` or a card.

`LAUNCHES` counts each kernel's launches (one per wrapper call that
launches it), so a caller can show that a path went through its kernels.
Each `nvcc` run's host seconds go to `utils/trace.py`'s SETUP as
"kernel_build.<source>".
`on_card` picks the route for a tensor: its kernel on a CUDA tensor, its
plain PyTorch version on a CPU tensor, nothing else. `fwd_rows` and
`fwd_tiles` give the window losses' forward tile (`csrc/window.cuh`), from
which their wrappers size both the launch and its scratch.
"""

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

from ..utils.trace import setup_timer

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = collections.Counter()

# The LNCC and SSIM forwards' tile (csrc/window.cuh): FWD_COLS outputs a
# row by one of FWD_ROWS rows, the tallest whose grid has a block for at
# least every FWD_SMS_A_BLOCK-th SM. The forward is latency-bound: on an
# H100 the 32-row tile is the fastest at 320² and 160² (400 and 100
# blocks), and the shorter tiles gain only where 32 rows leave most SMs
# idle (PERF.md, PR 12)
FWD_COLS = 32
FWD_ROWS = (32, 16, 8)
FWD_SMS_A_BLOCK = 2


def fwd_tiles(rows: int, cols: int, th: int) -> int:
    """Tiles a plane of rows x cols outputs of the forward at th rows a
    tile."""
    return -(-rows // th) * -(-cols // FWD_COLS)


def fwd_rows(planes: int, rows: int, cols: int, sms: int) -> int:
    """Output rows a tile of the LNCC or SSIM forward on `planes` planes of
    rows x cols outputs on a card of `sms` SMs: the tallest of FWD_ROWS
    whose grid has at least sms / FWD_SMS_A_BLOCK blocks, else the
    shortest. The wrappers size both the launch and the partials' scratch
    from it."""
    for th in FWD_ROWS:
        if FWD_SMS_A_BLOCK * planes * fwd_tiles(rows, cols, th) >= sms:
            return th
    return FWD_ROWS[-1]


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


def library(source: str) -> str:
    """The path `build` gives `csrc/<source>`'s library: named by a hash of
    the source, every header under `csrc/` (which a source may include)
    and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith((".cuh", ".h")))
    for name in (source, *headers):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read() + b"\0")
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str) -> tuple:
    """Compile `csrc/<source>` into `_build/` unless a library built from
    the same source and headers is there. Returns (library path, compiler
    log); the log is empty when the cached library was reused."""
    src = os.path.join(CSRC, source)
    lib = library(source)
    if os.path.exists(lib):
        return lib, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        with setup_timer(f"kernel_build.{source}"):
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
