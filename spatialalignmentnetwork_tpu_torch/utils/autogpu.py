"""Single-host card arbitration (the counterpart of the JAX package's
`utils/autotpu.py`; the reference's `autoGPU.py`).

Two jobs on one host should not race to the same cards, so arbitration
reduces to:

  * flock-based mutual exclusion (`Locker`), so that a second job waits
    for the first (or, non-blocking, learns that the host is taken);
  * optional restriction to a subset of cards via CUDA_VISIBLE_DEVICES,
    which CUDA reads once, when it initializes in the process.

Usage: call auto_gpu() before the first CUDA call; it blocks until the
host lock is free when exclusive=True.
"""

import fcntl
import os
import tempfile
import time

import torch

# under the temporary directory (TMPDIR), and not the TPU lock's name
LOCK_PATH = os.path.join(tempfile.gettempdir(), "wait_gpu_666.lock")


class Locker:
    """flock-based inter-process lock (reference autoGPU.py:44-83)."""

    def __init__(self, path=LOCK_PATH):
        self.path = path
        self.fd = None

    def acquire(self, blocking=True, poll=1.0):
        self.fd = open(self.path, "w")
        while True:
            try:
                fcntl.flock(
                    self.fd,
                    fcntl.LOCK_EX | (0 if blocking else fcntl.LOCK_NB),
                )
                return True
            except BlockingIOError:
                if not blocking:
                    return False
                time.sleep(poll)

    def release(self):
        if self.fd is not None:
            fcntl.flock(self.fd, fcntl.LOCK_UN)
            self.fd.close()
            self.fd = None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


def auto_gpu(visible_devices=None, exclusive=False):
    """Set card visibility and (optionally) take the per-host job lock.

    visible_devices: e.g. "0" or "0,1" -> CUDA_VISIBLE_DEVICES; raises
    RuntimeError once CUDA is initialized in this process, where the
    variable would have no effect.
    Returns a held Locker when exclusive=True (caller releases), else None.
    """
    if visible_devices is not None:
        if torch.cuda.is_initialized():
            raise RuntimeError(
                "CUDA is initialized already: CUDA_VISIBLE_DEVICES would have "
                "no effect; call auto_gpu before the first CUDA call"
            )
        os.environ["CUDA_VISIBLE_DEVICES"] = str(visible_devices)
    if exclusive:
        lock = Locker(LOCK_PATH)
        lock.acquire()
        return lock
    return None
