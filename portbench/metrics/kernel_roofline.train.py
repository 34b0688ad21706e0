"""kernel_roofline.train: The port's kernels on the train step's path (augmentation's and the
warps' grid samples, d_grid, d_img, SSIM forward and backward): their
operations' bound over their profiled device time."""

from harness.readers import kernel_roofline

UNIT = "%"


def read(r):
    return kernel_roofline(r, 'train')
