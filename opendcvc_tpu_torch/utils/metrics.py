"""Quality metrics (PSNR / MS-SSIM), host-side numpy.

Matches the reference metric conventions (reference: src/utils/metrics.py):
PSNR capped at 99.9 dB, MS-SSIM with HM-style level reduction for small
frames (5 levels, 4 below 176px, an error below 88px).  The port's copy
of the JAX package's `utils/metrics.py`, numpy and scipy only.
"""

import numpy as np
from scipy import signal, ndimage


def fspecial_gauss(size, sigma):
    x, y = np.mgrid[-size // 2 + 1: size // 2 + 1,
                    -size // 2 + 1: size // 2 + 1]
    g = np.exp(-((x ** 2 + y ** 2) / (2.0 * sigma ** 2)))
    return g / g.sum()


def calc_ssim(img1, img2, data_range=255):
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = fspecial_gauss(11, 1.5)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    mu1 = signal.fftconvolve(window, img1, mode="valid")
    mu2 = signal.fftconvolve(window, img2, mode="valid")
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = signal.fftconvolve(window, img1 * img1, mode="valid") - mu1_sq
    sigma2_sq = signal.fftconvolve(window, img2 * img2, mode="valid") - mu2_sq
    sigma12 = signal.fftconvolve(window, img1 * img2, mode="valid") - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / \
        ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    cs_map = (2.0 * sigma12 + C2) / (sigma1_sq + sigma2_sq + C2)
    return ssim_map, cs_map


def calc_msssim(img1, img2, data_range=255):
    """2D arrays."""
    level = 5
    weight = np.array([0.0448, 0.2856, 0.3001, 0.2363, 0.1333])
    height, width = img1.shape
    if height < 176 or width < 176:
        level = 4
        weight = np.array([0.0517, 0.3295, 0.3462, 0.2726])
    if height < 88 or width < 88:
        raise ValueError(f"MS-SSIM needs frames of at least 88x88, got "
                         f"{width}x{height}")
    downsample_filter = np.ones((2, 2)) / 4.0
    im1 = img1.astype(np.float64)
    im2 = img2.astype(np.float64)
    mssim = []
    mcs = []
    for _ in range(level):
        ssim_map, cs_map = calc_ssim(im1, im2, data_range=data_range)
        mssim.append(ssim_map.mean())
        mcs.append(cs_map.mean())
        im1 = ndimage.convolve(im1, downsample_filter, mode="reflect")[::2, ::2]
        im2 = ndimage.convolve(im2, downsample_filter, mode="reflect")[::2, ::2]
    mssim = np.array(mssim)
    mcs = np.array(mcs)
    return (np.prod(mcs[:level - 1] ** weight[:level - 1])
            * (mssim[level - 1] ** weight[level - 1]))


def calc_msssim_rgb(img1, img2, data_range=255):
    """(3,H,W) arrays."""
    return sum(calc_msssim(img1[i], img2[i], data_range)
               for i in range(3)) / 3


def calc_psnr(img1, img2, data_range=255):
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean(np.square(img1 - img2))
    if np.isnan(mse) or np.isinf(mse):
        return -999.9
    if mse > 1e-10:
        psnr = 10 * np.log10(data_range * data_range / mse)
    else:
        psnr = 999.9
    return min(psnr, 99.9)
