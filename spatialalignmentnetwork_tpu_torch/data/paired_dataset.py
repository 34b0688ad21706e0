"""Paired-volume h5 slice datasets (the port's own copy of the JAX
package's `data/paired_dataset.py`, numpy on the host).

The reference's data layer (paired_dataset.py:31-122): one h5 file a
volume with an `image` dataset [S, H, W] or [S, C, H, W] and `max` and
`acquisition` attributes; volumes are matched into aligned multi-modality
groups by protocol name from a CSV manifest; slices are normalised to
[0, 1] by the volume's max and center-cropped to a square; protocol
'None' stands for an all-zeros modality.

Slices come back as complex64 [C, H, W] numpy arrays. `h5py` is imported
by the functions that open files, not with the module: the eval path
imports this module on machines that have no `h5py` and hand it volumes
already in memory.
"""

import os

import numpy as np

from ..ops.crop import center_crop


class VolumeDataset:
    """Slices of one h5 volume (the reference's paired_dataset.py:31-73)."""

    def __init__(self, volume, crop=None, q=0, flatten_channels=False):
        import h5py

        if not q < 0.5:
            raise ValueError(f"q={q}: the fraction cut from each end must be < 0.5")
        self.volume = volume
        self.flatten_channels = flatten_channels
        self.crop = crop
        with h5py.File(volume, "r") as h5:
            shape = h5["image"].shape
            if len(shape) == 3:
                if flatten_channels:
                    raise ValueError(f"{volume}: no channel axis to flatten")
                length, self.channels = shape[0], 1
            elif len(shape) == 4:
                length, self.channels = shape[0:2]
            else:
                raise ValueError(f"bad image rank in {volume}")
            self.protocal = h5.attrs["acquisition"]
            self.max_val = h5.attrs["max"]
            if not self.max_val > 0:
                raise ValueError(
                    f"{volume}: max attr is {self.max_val}; slices would "
                    "normalize to NaN"
                )
        self.start = round(length * q)  # inclusive
        self.stop = length - self.start  # exclusive

    def __len__(self):
        n = self.stop - self.start
        return n * self.channels if self.flatten_channels else n

    def __getitem__(self, index):
        import h5py

        with h5py.File(self.volume, "r") as h5:
            if self.flatten_channels:
                i = h5["image"][index // self.channels + self.start]
                i = i[index % self.channels][None, ...]
            else:
                i = h5["image"][index + self.start][()]
                if i.ndim != 3:
                    i = i[None, ...]
        i = i / self.max_val
        if self.crop is not None:
            i = center_crop(i, (self.crop, self.crop))
        if i.ndim == 2:
            i = i[None, :, :]
        return i.astype(np.complex64)


class DummyVolumeDataset:
    """All-zeros stand-in for an absent modality (protocol 'None')."""

    def __init__(self, ref):
        sample = ref[0]
        self.shape = sample.shape
        self.dtype = sample.dtype
        self.len = len(ref)

    def __len__(self):
        return self.len

    def __getitem__(self, index):
        return np.zeros(self.shape, dtype=self.dtype)


class AlignedVolumesDataset:
    """Volumes matched by acquisition protocol; yields [target, aux, ...]
    lists of aligned slices (the reference's paired_dataset.py:89-110)."""

    def __init__(self, *volumes, protocals, crop=None, q=0,
                 flatten_channels=False):
        volumes = [
            VolumeDataset(x, crop, q=q, flatten_channels=flatten_channels)
            for x in volumes
        ]
        if len({len(x) for x in volumes}) != 1:
            raise ValueError(f"volumes of different lengths: {[x.volume for x in volumes]}")
        if len({x[0].shape for x in volumes}) != 1:
            raise ValueError(f"slices of different shapes: {[x.volume for x in volumes]}")
        self.crop = crop
        by_protocal = {v.protocal: v for v in volumes}
        by_protocal["None"] = DummyVolumeDataset(next(iter(by_protocal.values())))
        for x in protocals:
            if x not in by_protocal:
                raise KeyError(f"{x} not found in {list(by_protocal)}")
        self.volumes = [by_protocal[p] for p in protocals]

    def __len__(self):
        return len(self.volumes[0])

    def __getitem__(self, index):
        return [volume[index] for volume in self.volumes]


class ConcatDataset:
    """Concatenation of map-style datasets (a slice-level view of
    volumes)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, index):
        if index < 0:
            index += len(self)
        di = int(np.searchsorted(self.offsets, index, side="right")) - 1
        return self.datasets[di][index - int(self.offsets[di])]


class TiffPaired:
    """Side-by-side paired tiff images -> (t1, t2) complex slices (the
    reference's paired_dataset.py:124-142; needs imageio)."""

    def __init__(self, tiffs, crop=None):
        self.tiffs = list(tiffs)
        self.crop = crop

    def __len__(self):
        return len(self.tiffs)

    def __getitem__(self, ind):
        import imageio

        img = np.asarray(imageio.imread(self.tiffs[ind]))
        if img.ndim != 2:
            raise ValueError(f"{self.tiffs[ind]}: expected a 2-D image, got {img.shape}")
        t1, t2 = np.split(img, 2, axis=-1)
        out = []
        for x in (t1, t2):
            x = x[None].astype(np.complex64)
            if self.crop is not None:
                x = center_crop(x, (self.crop, self.crop))
            out.append(x)
        return out


def get_paired_volume_datasets(csv_path, protocals=None, crop=None, q=0,
                               flatten_channels=False):
    """CSV manifest -> a list of AlignedVolumesDatasets, one a row (the
    reference's paired_dataset.py:112-122); paths relative to the CSV's
    directory."""
    datasets = []
    basepath = os.path.dirname(os.path.abspath(csv_path))
    with open(csv_path, "r") as f:
        for line in f.readlines():
            paths = [
                os.path.join(basepath, p) for p in line.strip().split(",")
            ]
            datasets.append(
                AlignedVolumesDataset(
                    *paths, protocals=protocals, crop=crop, q=q,
                    flatten_channels=flatten_channels,
                )
            )
    return datasets
