"""VGG16 feature extractor for LPIPS (counterpart of
``compactfusion_tpu/eval/vgg.py``).

The 13-conv torchvision VGG16 ``features`` trunk with the five LPIPS taps
(after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3), the lpips scaling
layer, a converter from the torchvision ``vgg16`` state-dict naming and a
loader for the lpips linear-calibration weights.  Weights are kept in
PyTorch's OIHW layout and run as cuDNN convs with TF32 off
(``metrics.fp32_convs``); ``io/from_jax.py::conv_tree_from_jax`` takes the JAX
package's HWIO tree across.

Local-weights path (no network here): export torchvision's
``vgg16-397923af.pth`` and the lpips ``vgg.pth`` to safetensors or npz on a
connected machine; ``params = convert_vgg16(load_safetensors(path))``,
``lins = load_lpips_lins(load_safetensors(lin_path))``, ``lpips =
make_lpips(params, lins)``, ``d = lpips(a, b)`` with images (B, H, W, 3) in
[-1, 1].
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from compactfusion_tpu_torch.eval.metrics import fp32_convs, lpips_distance

#: torchvision vgg16 ``features`` conv layer indices and channel widths
VGG16_CONVS = (
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256),
    (17, 256, 512), (19, 512, 512), (21, 512, 512),
    (24, 512, 512), (26, 512, 512), (28, 512, 512),
)
#: feature taps AFTER the relu of these conv indices (relu{1..5}_x)
LPIPS_TAPS = (2, 7, 14, 21, 28)

#: lpips input normalization (the package's scaling layer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def init_vgg16(generator: torch.Generator, dtype=torch.float32) -> Dict[str, Any]:
    """Random weights with the torchvision topology (truncated normal at
    fan-in scale, zero biases), drawn on the generator's device."""
    dev = generator.device
    params = {}
    for idx, c_in, c_out in VGG16_CONVS:
        w = torch.nn.init.trunc_normal_(torch.empty(c_out, c_in, 3, 3, device=dev), generator=generator)
        params[f"conv{idx}"] = {"w": (w * (9 * c_in) ** -0.5).to(dtype),
                                "b": torch.zeros(c_out, dtype=dtype, device=dev)}
    return params


def convert_vgg16(state: Dict[str, np.ndarray], dtype=torch.float32, device="cuda"):
    """torchvision ``vgg16().features`` state dict -> param tree (OIHW) on
    ``device`` (the card unless the caller asks for the CPU)."""
    return {f"conv{idx}": {"w": torch.as_tensor(np.asarray(state[f"features.{idx}.weight"]), dtype=dtype,
                                                device=device),
                           "b": torch.as_tensor(np.asarray(state[f"features.{idx}.bias"]), dtype=dtype,
                                                device=device)}
            for idx, _, _ in VGG16_CONVS}


def load_lpips_lins(state: Dict[str, np.ndarray], dtype=torch.float32, device="cuda") -> List[torch.Tensor]:
    """lpips vgg.pth linear weights: lin{i}.model.1.weight (C_i, 1, 1, 1), on
    ``device`` (the card unless the caller asks for the CPU)."""
    return [torch.as_tensor(np.asarray(state[f"lin{i}.model.1.weight"]).reshape(-1), dtype=dtype, device=device)
            for i in range(5)]


def vgg16_features(params, images: torch.Tensor) -> List[torch.Tensor]:
    """(B, H, W, 3) in [-1, 1] -> the 5 LPIPS feature maps, (B, h, w, C)
    each (lpips-normalised input, 2 x 2 max-pool between stages)."""
    dev = images.device
    shift = torch.as_tensor(_SHIFT, device=dev)
    scale = torch.as_tensor(_SCALE, device=dev)
    x = ((images.float() - shift) / scale).permute(0, 3, 1, 2).contiguous()
    taps = []
    with fp32_convs():
        for idx, _, _ in VGG16_CONVS:
            p = params[f"conv{idx}"]
            x = F.relu(F.conv2d(x, p["w"].float(), p["b"].float(), padding=1))
            if idx in LPIPS_TAPS:
                taps.append(x.permute(0, 2, 3, 1))
                if idx != LPIPS_TAPS[-1]:
                    x = F.max_pool2d(x, 2)
    return taps


def make_lpips(params, lins: Optional[List[torch.Tensor]] = None):
    """The LPIPS callable: images (B, H, W, 3) in [-1, 1] -> (B,) distances.
    ``lins`` are the learned per-channel calibration weights; None is the
    lpips package's 'baseline' mode, which SUMS over channels before the
    spatial mean (each stage weighs by its channel count, like upstream).
    Both images go through the trunk as one batch of 2B."""

    @torch.no_grad()
    def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        feats = vgg16_features(params, torch.cat([a, b]))
        n = a.shape[0]
        return lpips_distance([f[:n] for f in feats], [f[n:] for f in feats], lins)

    return distance
