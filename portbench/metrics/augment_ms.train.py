"""augment_ms.train: Device ms a step of the augmentation and crop (CUDA events around the
benchmark's call of augment_batch and center_crop)."""

from harness.readers import augment_ms

UNIT = "ms"


def read(r):
    return augment_ms(r, 'train')
