"""Quality evaluation (counterpart of ``compactfusion_tpu/eval``): metric
maths (``metrics``) and the feature extractors ``vgg`` (VGG16 / LPIPS),
``inception`` (InceptionV3 pool features, FID) and ``i3d`` (I3D Kinetics
logits, FVD), each with a converter from local torchvision-named weights."""

from compactfusion_tpu_torch.eval.metrics import (  # noqa: F401
    mse,
    psnr,
    ssim,
)
