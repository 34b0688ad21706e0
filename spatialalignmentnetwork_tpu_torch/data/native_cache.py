"""Native slice cache: the build of `native/slicecache.cpp` and its ctypes
binding (the port's own copy of the JAX package's `data/native_cache.py`).

A CSV manifest of paired volumes is compiled once into one contiguous
float32 cache file a modality (slices normalised by their volume's max),
and the C++ OpenMP library assembles center-cropped complex64 batches
straight from the memory map. The port builds the library itself, with
the flags of `native/Makefile`, into its own `_build/` (named by a hash
of the source and the flags), and raises if the build fails: there is no
quiet fall back to the h5 path. `h5py` is imported where an h5 file is
opened.
"""

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import tempfile

import numpy as np

MAGIC = 0x53414E43414348

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "slicecache.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-march=x86-64-v2", "-fPIC", "-fopenmp", "-Wall", "-std=c++17", "-shared")


def build_library() -> str:
    """Compile native/slicecache.cpp with g++ (CXX) into `_build/`, named by
    a hash of the source and the flags, unless that library is there;
    returns its path. Raises RuntimeError with the compiler's output if the
    build fails."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    lib = os.path.join(BUILD_DIR, f"libslicecache_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"{cxx} not found: the native slice cache is built from "
                           f"{SOURCE} at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name, then rename: concurrent builds never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE} (rc {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


_LIB = None


def _load_lib():
    """Build if needed, load and declare the C interface, once a process."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build_library())
    lib.cache_open.restype = ctypes.c_void_p
    lib.cache_open.argtypes = [ctypes.c_char_p]
    lib.cache_num_slices.restype = ctypes.c_int64
    lib.cache_num_slices.argtypes = [ctypes.c_void_p]
    lib.cache_shape.restype = None
    lib.cache_shape.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.cache_assemble_batch.restype = ctypes.c_int
    lib.cache_assemble_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
    ]
    lib.cache_close.restype = None
    lib.cache_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def write_cache(volume_paths, out_path):
    """Pack the normalised slices of h5 volumes into one cache file; returns
    the slice count of each volume.

    All volumes must share one (C, H, W) slice shape (the file stores one
    shape and crops are computed against it) and be real-valued (the f32
    store would drop an imaginary part); either fault raises."""
    import h5py

    counts = []
    with open(out_path, "wb") as f:
        header_pos = f.tell()
        f.write(np.zeros(5, dtype=np.int64).tobytes())  # placeholder
        total, chw = 0, None
        for path in volume_paths:
            with h5py.File(path, "r") as h5:
                raw = h5["image"]
                if np.issubdtype(raw.dtype, np.complexfloating):
                    raise ValueError(
                        f"{path}: complex-valued image dataset; the native f32 cache "
                        "would drop the imaginary part: use the python loader")
                img = np.asarray(raw, dtype=np.float32)
                peak = np.float32(h5.attrs["max"])
                if not peak > 0:
                    raise ValueError(f"{path}: max attr is {peak}; slices would "
                                     "normalize to NaN")
                img = img / peak
            if img.ndim == 3:
                img = img[:, None]
            s = img.shape[0]
            if chw is None:
                chw = img.shape[1:]
            if img.shape[1:] != chw:
                raise ValueError(
                    f"{path}: volume shape {img.shape[1:]} != cache shape {chw}; the "
                    "native cache needs one slice shape a protocol: use the python "
                    "loader for mixed-shape splits")
            f.write(np.ascontiguousarray(img).tobytes())
            counts.append(s)
            total += s
        c, h, w = chw if chw is not None else (1, 0, 0)
        f.seek(header_pos)
        f.write(np.asarray([MAGIC, total, c, h, w], dtype=np.int64).tobytes())
    return counts


class NativeSliceCache:
    """A memory-mapped slice store with native batch assembly."""

    def __init__(self, path):
        self._handle = None
        self._lib = _load_lib()
        self._handle = self._lib.cache_open(path.encode())
        if not self._handle:
            raise OSError(f"cannot open cache {path}")
        chw = (ctypes.c_int64 * 3)()
        self._lib.cache_shape(self._handle, chw)
        self.channels, self.height, self.width = chw[0], chw[1], chw[2]

    def __len__(self):
        return int(self._lib.cache_num_slices(self._handle))

    def batch(self, indices, crop):
        """indices -> [N, C, crop, crop] complex64 batch."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        n = len(idx)
        out = np.empty((n, self.channels, crop, crop), dtype=np.complex64)
        rc = self._lib.cache_assemble_batch(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, crop, crop, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IndexError("slice index out of range")
        return out

    def close(self):
        if self._handle:
            self._lib.cache_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativePairedSlices:
    """A paired-modality dataset over native caches built from one CSV
    manifest, batches assembled natively (`Loader` calls `batch`). A
    single-modal run (protocals like ['T2', 'None']) has one cache: the
    zeros the python path's DummyVolumeDataset gives are made by
    `CSModel.set_input(img_aux=None)` instead."""

    def __init__(self, cache_paths, crop):
        self.caches = [NativeSliceCache(p) for p in cache_paths]
        lens = {len(c) for c in self.caches}
        if len(lens) != 1:
            raise ValueError(f"modalities must align slice-for-slice, got totals {lens}")
        self.crop = crop

    def __len__(self):
        return len(self.caches[0])

    def batch(self, indices):
        return [c.batch(indices, self.crop) for c in self.caches]

    def __getitem__(self, ind):
        """One item [modality...] of [C, crop, crop], as the python paired
        datasets give it."""
        return [c.batch(np.asarray([ind]), self.crop)[0] for c in self.caches]


def build_caches_from_csv(csv_path, protocals, out_dir, reuse=True):
    """Compile a paired CSV manifest into one cache file a protocol under
    `out_dir`; returns their paths.

    Volumes are matched by their `acquisition` attribute, as
    `get_paired_volume_datasets` does; protocol 'None' has no file. The
    per-volume slice counts must agree across protocols (else every later
    slice would pair with the wrong one), which raises otherwise. With
    `reuse`, a protocol whose cache is newer than the CSV and every volume
    it was built from is kept. Writes go to a pid-suffixed file renamed
    into place, so that concurrent builders never see a torn cache."""
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    basepath = os.path.dirname(os.path.abspath(csv_path))
    per_protocol = {p: [] for p in protocals if p != "None"}
    with open(csv_path) as f:
        for line in f.readlines():
            by_acq = {}
            for p in line.strip().split(","):
                path = os.path.join(basepath, p)
                with h5py.File(path, "r") as h5:
                    by_acq[h5.attrs["acquisition"]] = path
            for p in per_protocol:
                per_protocol[p].append(by_acq[p])
    outs, per_volume_counts = [], {}
    for p, vols in per_protocol.items():
        out = os.path.join(out_dir, f"cache_{p}.bin")
        counts_path = out + ".counts.json"
        newest_input = max([os.path.getmtime(csv_path)] + [os.path.getmtime(v) for v in vols])
        if (reuse and os.path.exists(out) and os.path.exists(counts_path)
                and os.path.getmtime(out) > newest_input):
            with open(counts_path) as cf:
                per_volume_counts[p] = json.load(cf)
        else:
            tmp, tmp_counts = f"{out}.tmp.{os.getpid()}", f"{counts_path}.tmp.{os.getpid()}"
            counts = write_cache(vols, tmp)
            with open(tmp_counts, "w") as cf:
                json.dump(counts, cf)
            os.replace(tmp, out)
            os.replace(tmp_counts, counts_path)
            per_volume_counts[p] = counts
        outs.append(out)
    if per_volume_counts:
        ref_p, ref_counts = next(iter(per_volume_counts.items()))
        for p, cnts in per_volume_counts.items():
            if cnts != ref_counts:
                raise ValueError(
                    f"per-volume slice counts differ between protocols {ref_p} and {p}: "
                    f"{ref_counts} vs {cnts}; the caches would mis-pair slices")
    return outs
