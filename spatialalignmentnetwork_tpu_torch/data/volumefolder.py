"""Legacy folder-of-npy-slices volumes (the port's own copy of the JAX
package's `data/volumefolder.py`; the reference's volumefolder.py:28-163).

A volume is a directory of per-slice .npy files and a `description.json`
that names its acquisition protocol; `get_aligned_volumes` pairs adjacent
CORPD_FBK / CORPDFS_FBK knee volumes; `pair_qc` checks a pairing by the
mutual information of each pair. The brain T1/T2 pipeline does not use
it: it reads older experiments' data.

    python -m spatialalignmentnetwork_tpu_torch.data.volumefolder ROOT [IMAGE_DIR]
"""

import argparse
import glob
import json
import os

import numpy as np

from ..ops.crop import center_crop


class VolumeDataset:
    """One volume: a folder of per-slice npy files (a [real, imag] stack, or
    a real [H, W] slice)."""

    def __init__(self, folder, crop=None, q=0):
        if not q < 0.5:
            raise ValueError(f"q={q}: the fraction cut from each end must be < 0.5")
        self.folder = folder
        self.crop = crop
        with open(os.path.join(folder, "description.json")) as f:
            self.description = json.load(f)
        self.protocal = self.description.get("acquisition")
        self.slices = sorted(glob.glob(os.path.join(folder, "*.npy")))
        n = len(self.slices)
        self.start = round(n * q)
        self.stop = n - self.start

    def __len__(self):
        return self.stop - self.start

    def __getitem__(self, index):
        arr = np.load(self.slices[index + self.start])
        if arr.ndim == 3 and arr.shape[0] == 2:  # [real, imag] stack
            arr = (arr[0] + 1j * arr[1])[None]
        elif arr.ndim == 2:
            arr = arr[None]
        if self.crop is not None:
            arr = center_crop(arr, (self.crop, self.crop))
        return arr.astype(np.complex64)


class AlignedVolumesDataset:
    """Volumes of one subject matched by protocol; yields [volume...] lists
    of aligned slices in the order of `protocals`."""

    def __init__(self, *folders, protocals, crop=None, q=0):
        volumes = [VolumeDataset(f, crop=crop, q=q) for f in folders]
        if len({len(v) for v in volumes}) != 1:
            raise ValueError(f"volumes of different lengths: {list(folders)}")
        by_protocal = {v.protocal: v for v in volumes}
        self.volumes = [by_protocal[p] for p in protocals]

    def __len__(self):
        return len(self.volumes[0])

    def __getitem__(self, index):
        return [v[index] for v in self.volumes]


def get_volumes(root):
    """Every volume folder under root (those holding description.json)."""
    return [VolumeDataset(folder) for folder in sorted(glob.glob(os.path.join(root, "*")))
            if os.path.isfile(os.path.join(folder, "description.json"))]


def get_aligned_volumes(root, protocals=("CORPD_FBK", "CORPDFS_FBK"), crop=None, q=0):
    """Adjacent volumes with the two complementary knee protocols and one
    slice count, paired (the reference's volumefolder.py:93-111)."""
    volumes = get_volumes(root)
    datasets = []
    i = 0
    while i < len(volumes) - 1:
        a, b = volumes[i], volumes[i + 1]
        if {a.protocal, b.protocal} == set(protocals) and len(a) == len(b):
            datasets.append(AlignedVolumesDataset(a.folder, b.folder, protocals=list(protocals),
                                                  crop=crop, q=q))
            i += 2
        else:
            i += 1
    return datasets


def qc_mi(x, y, bins=200, eps=1e-6):
    """Whole-volume MI of the pair-QC tool (the reference's
    volumefolder.py:115-124): values clipped to [0, 1], one `bins`-bin
    joint histogram over the whole volume, and the eps-smoothed KL form
    sum(pxy * log((pxy + eps) / (px py + eps)))."""
    x, y = (np.clip(np.asarray(v), 0, 1).ravel().astype(np.float64) for v in (x, y))
    pxy = np.histogram2d(x, y, bins, range=((0, 1), (0, 1)))[0]
    pxy = pxy / pxy.sum()
    px_py = pxy.sum(axis=1)[:, None] * pxy.sum(axis=0)[None, :]
    return float(np.sum(pxy * np.log((pxy + eps) / (px_py + eps))))


def pair_qc(root, image_dir=None, crop=256, bins=200):
    """Check the protocol pairing under `root` by mutual information (the
    reference's volumefolder.py:113-163): for each aligned pair, the
    magnitude stacks center-cropped to crop x crop, their whole-volume MI
    printed as a CSV row (index, len, folderA, folderB, mi), side-by-side
    slice JPEGs written to `image_dir` if given, then the max, min, mean
    and std of the MIs. A mispaired volume shows as an outlier. Returns
    the MI of each pair."""
    mis = []
    cnt = 0
    for ds in get_aligned_volumes(root):
        a, b = ds.volumes
        try:
            stacks = [np.abs(np.concatenate([v[i] for i in range(len(v))], 0)) for v in (a, b)]
        except (OSError, ValueError) as e:  # an unreadable volume: skipped, as in the reference
            print(f"# skipping {a.folder}: {e}")
            continue
        pd, pdfs = (center_crop(s, (crop, crop)) for s in stacks)
        m = qc_mi(pd, pdfs, bins=bins)
        print(cnt, len(ds), os.path.basename(a.folder), os.path.basename(b.folder), m, sep=",")
        if image_dir is not None:
            from PIL import Image

            os.makedirs(image_dir, exist_ok=True)
            for offset, (x, y) in enumerate(zip(pd, pdfs)):
                img = np.concatenate((x, np.ones((x.shape[0], 5)), y), 1)
                img = np.clip(np.floor(img * 256), 0, 255).astype(np.uint8)
                Image.fromarray(img).save(os.path.join(image_dir, f"{cnt + offset:010d}.jpg"))
        mis.append(m)
        cnt += len(ds)
    if mis:
        print(len(mis), np.max(mis), np.min(mis), np.mean(mis), np.std(mis))
    else:
        print("no aligned volume pairs found under", root)
    return mis


def main(argv=None):
    ap = argparse.ArgumentParser(description="MI-based pairing QC over a legacy volume folder")
    ap.add_argument("root", help="folder of volume folders")
    ap.add_argument("image_dir", nargs="?", default=None,
                    help="optional dir for side-by-side slice JPEGs")
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--bins", type=int, default=200)
    a = ap.parse_args(argv)
    return pair_qc(a.root, a.image_dir, crop=a.crop, bins=a.bins)


if __name__ == "__main__":
    main()
