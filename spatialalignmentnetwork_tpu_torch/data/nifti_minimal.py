"""Minimal numpy NIfTI-1 reader and writer (the port's own copy of the JAX
package's `data/nifti_minimal.py`; `data.convert` falls back to it where
nibabel is not installed).

It implements the subset of NIfTI-1 that the fastMRI brain exports use,
and refuses anything outside it rather than guess: single-file .nii and
.nii.gz, magic "n+1", 3-D volumes, integer and float dtypes,
scl_slope/scl_inter scaling, an axis-aligned sform or the pixdim-scaled
identity, and reorientation to canonical RAS by axis permutation and
flips (what nibabel's `as_closest_canonical` gives for an axis-aligned
affine).

The reference converts DICOM series with pydicom and nibabel
(convert_fastMRIDICOM.py:6-18); this module covers only the volume
loading that feeds `data.convert.write_h5`.
"""

import gzip
import os
import struct

import numpy as np

# NIfTI-1 datatype codes -> numpy dtypes (the analyze/nifti common set)
_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64,
}

_HDR_SIZE = 348


def _open(path):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_nii(path):
    """Load `path` -> (data[float32, x,y,z], affine[4,4]).

    Data is returned in on-disk (x fastest) index order; pair with
    `to_canonical` for RAS orientation.
    """
    with _open(path) as f:
        hdr = f.read(_HDR_SIZE)
        if len(hdr) < _HDR_SIZE:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        endian = "<"
        if sizeof_hdr != _HDR_SIZE:
            sizeof_hdr = struct.unpack(">i", hdr[0:4])[0]
            if sizeof_hdr != _HDR_SIZE:
                raise ValueError(f"{path}: not a NIfTI-1 file "
                                 f"(sizeof_hdr={sizeof_hdr})")
            endian = ">"
        magic = hdr[344:348]
        if magic[:3] not in (b"n+1", b"ni1"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
        if magic[:3] == b"ni1":
            raise ValueError(
                f"{path}: two-file (.hdr/.img) NIfTI is not supported by "
                "the minimal reader; install nibabel"
            )

        dim = struct.unpack(endian + "8h", hdr[40:56])
        ndim = dim[0]
        if not 1 <= ndim <= 7:
            raise ValueError(f"{path}: implausible dim[0]={ndim}")
        shape = tuple(dim[1:1 + ndim])
        # trailing singleton time/channel axes are fine; real 4-D is not
        while len(shape) > 3 and shape[-1] == 1:
            shape = shape[:-1]
        if len(shape) != 3:
            raise ValueError(
                f"{path}: expected a 3-D volume, got shape {shape}; "
                "install nibabel for 4-D handling"
            )

        datatype = struct.unpack(endian + "h", hdr[70:72])[0]
        if datatype not in _DTYPES:
            raise ValueError(
                f"{path}: unsupported NIfTI datatype code {datatype}; "
                "install nibabel"
            )
        np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

        pixdim = struct.unpack(endian + "8f", hdr[76:108])
        vox_offset = struct.unpack(endian + "f", hdr[108:112])[0]
        scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
        scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]
        qform_code = struct.unpack(endian + "h", hdr[252:254])[0]
        sform_code = struct.unpack(endian + "h", hdr[254:256])[0]
        srows = np.array(
            struct.unpack(endian + "12f", hdr[280:328]), np.float64
        ).reshape(3, 4)

        count = int(np.prod(shape))
        f.seek(int(vox_offset))
        raw = f.read(count * np_dtype.itemsize)
        if len(raw) != count * np_dtype.itemsize:
            raise ValueError(f"{path}: truncated voxel data")

    # NIfTI voxel data is Fortran-ordered (x fastest)
    data = np.frombuffer(raw, dtype=np_dtype).reshape(shape, order="F")
    data = data.astype(np.float32)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * np.float32(slope) + np.float32(scl_inter)

    if sform_code > 0:
        affine = np.eye(4)
        affine[:3, :] = srows
    elif qform_code > 0:
        raise ValueError(
            f"{path}: qform-only orientation needs the quaternion math; "
            "install nibabel"
        )
    else:
        # NIfTI "method 1": pixdim-scaled identity
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0,
                          pixdim[3] or 1.0, 1.0])
    return data, affine


def to_canonical(data, affine):
    """Reorient to RAS for an axis-aligned affine (permutation + flips).

    Matches nibabel `as_closest_canonical(...).get_fdata()` whenever each
    affine column has a single dominant axis (true for every scanner
    export this pipeline consumes); raises on oblique affines instead of
    silently mis-orienting.
    """
    rot = np.asarray(affine, np.float64)[:3, :3]
    if not np.isfinite(rot).all() or np.linalg.det(rot) == 0:
        raise ValueError(f"degenerate affine:\n{affine}")
    # column j of `rot` says where voxel axis j points in world space
    world_axis = np.argmax(np.abs(rot), axis=0)
    if sorted(world_axis) != [0, 1, 2]:
        raise ValueError(
            "oblique affine (no one-to-one voxel->world axis map); "
            f"install nibabel:\n{affine}"
        )
    # reject strongly oblique scans even when argmax is one-to-one
    for j in range(3):
        col = np.abs(rot[:, j])
        if col[world_axis[j]] < 0.9 * np.linalg.norm(col):
            raise ValueError(
                f"affine column {j} is oblique; install nibabel:\n{affine}"
            )
    perm = np.argsort(world_axis)          # voxel axis holding world x,y,z
    out = np.transpose(data, perm)
    for w in range(3):
        if rot[w, perm[w]] < 0:            # points toward -world: flip
            out = np.flip(out, axis=w)
    return np.ascontiguousarray(out)


def write_nii(path, data, pixdim=(1.0, 1.0, 1.0), affine=None):
    """Write a 3-D float32 volume as single-file NIfTI-1 (.nii / .nii.gz).

    For synthetic NIfTI inputs of the converter and for QC viewers.
    `affine` (4x4, axis-aligned) lands in the sform; default is a
    pixdim-scaled identity RAS affine.
    """
    data = np.asarray(data, np.float32)
    if data.ndim != 3:
        raise ValueError(f"write_nii expects 3-D data, got {data.shape}")
    if affine is None:
        affine = np.diag([pixdim[0], pixdim[1], pixdim[2], 1.0])
    affine = np.asarray(affine, np.float64)

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, 16)                    # float32
    struct.pack_into("<h", hdr, 72, 32)                    # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, *pixdim, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)                # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                  # scl_slope
    struct.pack_into("<h", hdr, 254, 1)                    # sform: scanner
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].ravel())
    hdr[344:348] = b"n+1\x00"
    hdr_bytes = bytes(hdr) + b"\x00" * 4                   # extender

    opener = gzip.open if path.endswith(".gz") else open
    tmp = path + ".tmp"
    with opener(tmp, "wb") as f:
        f.write(hdr_bytes)
        f.write(np.asfortranarray(data).tobytes(order="F"))
    os.replace(tmp, path)
