"""Image and video quality metrics (counterpart of
``compactfusion_tpu/eval/metrics.py``).

Images are (B, H, W, C) and videos (B, F, H, W, C), the layout the port's
pipelines return, in [0, ``data_range``].  PSNR, SSIM and their per-frame
video forms run in fp32 on the tensors' device; SSIM's Gaussian filter is
one depthwise cuDNN conv, run with TF32 off (:func:`fp32_convs`) so that
the card computes what the CPU does.  The Frechet maths (FID, FVD) stays
numpy and scipy on the host.  :class:`LPIPS` takes features from any
extractor (``eval/vgg.py::make_lpips`` is the VGG16 one).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def fp32_convs():
    """cuDNN convolutions in full fp32 within the block: cuDNN may use TF32
    by default, which moves fp32 features by about 1e-3.  The other cuDNN
    flags keep their values, and the previous ones come back on exit."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio; inputs (..., H, W, C) in [0, data_range].

    With a batch dimension (ndim == 4), the MEAN of per-image PSNRs (the
    reference eval harness's convention: one bad image must not dominate
    every good one).  The MSE is floored at 1e-12, so equal images give
    120 dB at data_range 1."""
    a32, b32 = a.float(), b.float()
    m = torch.mean((a32 - b32) ** 2, dim=(1, 2, 3)) if a.ndim == 4 else mse(a, b)
    return torch.mean(10.0 * torch.log10(data_range**2 / torch.clamp(m, min=1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / torch.sum(g)
    return g[:, None] * g[None, :]


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Structural similarity for (B, H, W, C) images (Wang et al.: an 11 x
    11 Gaussian of sigma 1.5, VALID, constants 0.01 and 0.03), the mean over
    every pixel and channel."""
    a, b = a.float(), b.float()
    c = a.shape[-1]
    # the five filtered maps in one depthwise conv: a, b, a^2, b^2, ab
    stack = torch.cat([a, b, a * a, b * b, a * b], dim=-1).permute(0, 3, 1, 2)
    kern = _gaussian_kernel(kernel_size, sigma).to(a.device).expand(5 * c, 1, kernel_size, kernel_size)
    with fp32_convs():
        mu_a, mu_b, e_aa, e_bb, e_ab = F.conv2d(stack, kern, groups=5 * c).split(c, dim=1)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a, var_b, cov = e_aa - mu_a2, e_bb - mu_b2, e_ab - mu_ab
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * mu_ab + c1) * (2 * cov + c2)) / ((mu_a2 + mu_b2 + c1) * (var_a + var_b + c2))
    return torch.mean(s)


def _frames(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def video_psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Mean per-frame PSNR for (B, F, H, W, C) videos (reference
    calculate_psnr.py: the average over frames)."""
    return psnr(_frames(a), _frames(b), data_range)


def video_ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Mean per-frame SSIM for (B, F, H, W, C) videos: every frame has the
    same number of pixels, so the mean of the per-frame means is the mean
    over all frames at once."""
    return ssim(_frames(a), _frames(b), data_range)


# ---------------------------------------------------------------------------
# FID / FVD: metric maths over features from any extractor
# ---------------------------------------------------------------------------


def frechet_distance(mu_a: np.ndarray, cov_a: np.ndarray, mu_b: np.ndarray, cov_b: np.ndarray) -> float:
    """Frechet distance between two Gaussians; usable directly with published
    precomputed statistics (cleanfid / pytorch-fid ``mu``/``sigma``)."""
    import scipy.linalg

    diff = mu_a - mu_b
    covmean = scipy.linalg.sqrtm(cov_a @ cov_b)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov_a + cov_b - 2.0 * covmean))


def feature_stats(feat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu, cov), the sufficient statistics of FID/FVD."""
    return feat.mean(0), np.cov(feat, rowvar=False)


def load_fid_stats_npz(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Precomputed FID statistics (the cleanfid/pytorch-fid .npz layout:
    ``mu`` and ``sigma``)."""
    with np.load(path) as z:
        return np.asarray(z["mu"]), np.asarray(z["sigma"])


def fid_from_features(feat_a: np.ndarray, feat_b: np.ndarray) -> float:
    """Frechet distance between two (N, D) feature sets (InceptionV3 pool
    features, ``eval/inception.py``, for FID)."""
    return frechet_distance(*feature_stats(feat_a), *feature_stats(feat_b))


def fvd_from_features(feat_a: np.ndarray, feat_b: np.ndarray) -> float:
    """Frechet Video Distance over per-clip features (N, D): I3D logits
    (``eval/i3d.py``), the reference's calculate_fvd.py."""
    return fid_from_features(feat_a, feat_b)


def _unit_channels(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-10)


def lpips_distance(fa, fb, weights=None) -> torch.Tensor:
    """The LPIPS aggregation over two lists of (B, H, W, C) feature maps:
    normalise each map per channel vector (eps 1e-10), square the
    differences, weight them per channel where ``weights`` (one (C,) tensor
    a map) are given, SUM over channels and average over space (the lpips
    package's ``spatial_average(diff.sum(dim=1))``).  Returns (B,)."""
    total = 0.0
    for i, (xa, xb) in enumerate(zip(fa, fb)):
        d2 = (_unit_channels(xa) - _unit_channels(xb)) ** 2
        if weights is not None:
            d2 = d2 * weights[i]
        total = total + torch.mean(torch.sum(d2, dim=-1), dim=(1, 2))
    return total


class LPIPS:
    """LPIPS distance given a feature extractor ``extractor(images) -> list
    of (B, H, W, C) feature maps``; ``weights`` scale each map's distance
    (the JAX class's per-map scalars)."""

    def __init__(self, extractor, weights=None):
        self.extractor = extractor
        self.weights = weights

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa, fb = self.extractor(a), self.extractor(b)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            d = lpips_distance([xa], [xb])
            if self.weights is not None:
                d = d * self.weights[i]
            total = total + d
        return total
