"""NIfTI -> h5 volume conversion and manifest generation (the port's own
copy of the JAX package's `data/convert.py`).

Writes the h5 layout the paired datasets read (one float32 slice-major
`image` dataset with `max` and `acquisition` attributes: the format of
the reference's converter, convert_fastMRIDICOM.py:6-18):

  * one file:       python -m spatialalignmentnetwork_tpu_torch.data.convert \
                        in.nii out.h5 T1
  * batch + CSV:    python -m spatialalignmentnetwork_tpu_torch.data.convert \
                        --batch dir_T1 dir_T2 --protocals T1 T2 --out data/ \
                        --manifest pairs.csv

Volumes are reoriented to canonical RAS so that left and right agree
across scanners, transposed to slice-major [S, H, W], and checked (finite,
a positive max, equal slice counts across the modalities of a pair).
nibabel is used where it is installed, else `data/nifti_minimal.py`;
nibabel and h5py are imported where they are used.
"""

import argparse
import os

import numpy as np


def nii_to_array(nii_path):
    """A NIfTI volume as slice-major float32 [S, H, W] in RAS orientation:
    through nibabel where it is installed, else the minimal NIfTI-1 reader,
    which covers the axis-aligned single-file subset of scanner exports
    and raises on anything it cannot reorient exactly."""
    try:
        import nibabel as nib
    except ImportError:
        from . import nifti_minimal

        data, affine = nifti_minimal.read_nii(nii_path)
        vol = nifti_minimal.to_canonical(data, affine)
    else:
        vol = nib.as_closest_canonical(nib.load(nii_path)).get_fdata()
    array = np.ascontiguousarray(vol.T, dtype=np.float32)
    if array.ndim != 3:
        raise ValueError(f"{nii_path}: expected a 3-D volume, got {array.shape}")
    if not np.isfinite(array).all():
        raise ValueError(f"{nii_path}: non-finite voxels after load")
    return array


def write_h5(array, h5_path, protocal):
    """Write one volume in the layout the datasets read. A volume whose max
    is not positive raises: every reader divides by it."""
    import h5py

    peak = float(array.max())
    if not peak > 0:
        raise ValueError(
            f"volume for {h5_path} has max {peak}; refusing to write an h5 whose "
            "normalization divides by zero")
    with h5py.File(h5_path, "w") as h5:
        h5.create_dataset("image", data=array)
        h5.attrs["max"] = peak
        h5.attrs["acquisition"] = protocal


def convert(nii_path, h5_path, protocal):
    write_h5(nii_to_array(nii_path), h5_path, protocal)


def convert_batch(dirs, protocals, out_dir, manifest):
    """Convert per-modality directories of .nii[.gz] files and write a
    pairs CSV. Files pair by sorted order within each directory; the
    directories must hold as many volumes, and each pair one slice count."""
    if not len(dirs) == len(protocals) >= 2:
        raise ValueError(f"need one protocol a directory, two or more: {dirs}, {protocals}")
    os.makedirs(out_dir, exist_ok=True)
    listings = []
    for d in dirs:
        names = sorted(f for f in os.listdir(d) if f.endswith((".nii", ".nii.gz")))
        if not names:
            raise FileNotFoundError(f"no NIfTI files in {d}")
        listings.append(names)
    if len({len(x) for x in listings}) != 1:
        raise ValueError("modality directories hold different volume counts: "
                         + str({d: len(x) for d, x in zip(dirs, listings)}))
    rows = []
    for i, group in enumerate(zip(*listings)):
        outs, slices = [], set()
        for d, proto, name in zip(dirs, protocals, group):
            array = nii_to_array(os.path.join(d, name))
            out_name = f"v{i:04d}_{proto}.h5"
            write_h5(array, os.path.join(out_dir, out_name), proto)
            outs.append(out_name)
            slices.add(array.shape[0])
        if len(slices) != 1:
            raise ValueError(f"pair {group}: slice counts differ: {slices}")
        rows.append(",".join(outs))
    with open(os.path.join(out_dir, manifest), "w") as f:
        f.write("\n".join(rows) + "\n")
    print(f"converted {len(rows)} pairs -> {out_dir}/{manifest}")


def main(argv=None):
    p = argparse.ArgumentParser(description="NIfTI -> h5 volume conversion")
    p.add_argument("paths", nargs="*", help="one file: IN.nii OUT.h5 PROTOCAL")
    p.add_argument("--batch", nargs="+", metavar="DIR", help="per-modality NIfTI directories")
    p.add_argument("--protocals", nargs="+", metavar="NAME")
    p.add_argument("--out", default=".", help="output directory (batch)")
    p.add_argument("--manifest", default="pairs.csv")
    args = p.parse_args(argv)
    if args.batch:
        if not args.protocals or len(args.protocals) != len(args.batch):
            p.error("--batch needs --protocals with one name per directory "
                    f"(got {len(args.batch)} dirs, {len(args.protocals or [])} protocals)")
        convert_batch(args.batch, args.protocals, args.out, args.manifest)
    elif len(args.paths) == 3:
        convert(*args.paths)
    else:
        p.error("expected IN.nii OUT.h5 PROTOCAL or --batch ...")


if __name__ == "__main__":
    main()
