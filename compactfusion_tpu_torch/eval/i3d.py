"""I3D (Inflated 3D Inception) feature extractor for FVD (counterpart of
``compactfusion_tpu/eval/i3d.py``).

The Inception-v1 trunk inflated to 3D with TF-style "SAME" padding, the
eval-mode BatchNorms (eps 1e-3) folded into the convs at load time, and the
400-d averaged Kinetics logits (the standard FVD feature) or the 1024-d
pre-logits.  "SAME" pads asymmetrically at stride 2 (the extra element
after), which ``padding="same"`` in PyTorch does not do, so every conv and
max-pool pads explicitly (:func:`_same_pad`): zeros before a conv, -inf
before a max-pool, as JAX's ``reduce_window`` pads.  Weights stay in
PyTorch's OIDHW layout and run as cuDNN convs with TF32 off;
``io/from_jax.py::conv_tree_from_jax`` takes the JAX package's DHWIO tree across.

Weights use the piergiaj/pytorch-i3d naming (``Conv3d_1a_7x7.conv3d.weight``,
``Mixed_3b.b0.bn.running_var``, ``logits.conv3d.{weight,bias}``);
``params = convert_i3d(load_safetensors(path))``, then
``i3d_features(params, videos)`` with videos (B, T, 224, 224, 3) in [-1, 1],
T >= 10, and ``metrics.fvd_from_features``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from compactfusion_tpu_torch.eval.metrics import fp32_convs

#: Inception-v1 mixed-block channel table: prefix -> (in, [b0, b1a, b1b,
#: b2a, b2b, b3b])
I3D_MIXED = (
    ("Mixed_3b", 192, (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", 256, (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", 480, (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", 512, (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", 512, (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", 512, (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", 528, (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", 832, (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", 832, (384, 192, 384, 48, 128, 128)),
)

#: every Unit3D: name -> (c_in, c_out, kernel, stride)
I3D_UNITS: Dict[str, Any] = {
    "Conv3d_1a_7x7": (3, 64, (7, 7, 7), (2, 2, 2)),
    "Conv3d_2b_1x1": (64, 64, (1, 1, 1), (1, 1, 1)),
    "Conv3d_2c_3x3": (64, 192, (3, 3, 3), (1, 1, 1)),
}
for _prefix, _cin, _b in I3D_MIXED:
    I3D_UNITS[f"{_prefix}.b0"] = (_cin, _b[0], (1, 1, 1), (1, 1, 1))
    I3D_UNITS[f"{_prefix}.b1a"] = (_cin, _b[1], (1, 1, 1), (1, 1, 1))
    I3D_UNITS[f"{_prefix}.b1b"] = (_b[1], _b[2], (3, 3, 3), (1, 1, 1))
    I3D_UNITS[f"{_prefix}.b2a"] = (_cin, _b[3], (1, 1, 1), (1, 1, 1))
    I3D_UNITS[f"{_prefix}.b2b"] = (_b[3], _b[4], (3, 3, 3), (1, 1, 1))
    I3D_UNITS[f"{_prefix}.b3b"] = (_cin, _b[5], (1, 1, 1), (1, 1, 1))

FEATURE_DIM = 400  # Kinetics-400 logits
PRE_LOGITS_DIM = 1024


def init_i3d(generator: torch.Generator, dtype=torch.float32) -> Dict[str, Any]:
    """Random weights with the pytorch-i3d topology (truncated normal at
    fan-in scale, zero biases), drawn on the generator's device."""
    dev = generator.device

    def unit(c_in, c_out, k):
        w = torch.nn.init.trunc_normal_(torch.empty((c_out, c_in) + k, device=dev), generator=generator)
        return {"w": (w * (c_in * k[0] * k[1] * k[2]) ** -0.5).to(dtype),
                "b": torch.zeros(c_out, dtype=dtype, device=dev)}

    params = {name: unit(c_in, c_out, k) for name, (c_in, c_out, k, _) in I3D_UNITS.items()}
    params["logits"] = unit(PRE_LOGITS_DIM, FEATURE_DIM, (1, 1, 1))
    return params


def convert_i3d(state: Dict[str, np.ndarray], dtype=torch.float32, eps: float = 1e-3, device="cuda"):
    """pytorch-i3d state dict -> param tree (OIDHW) with the eval-mode BN
    folded in numpy fp32, as the JAX package folds it; on ``device`` (the
    card unless the caller asks for the CPU)."""
    params = {}
    for name in I3D_UNITS:
        w = np.asarray(state[f"{name}.conv3d.weight"], np.float32)
        g = np.asarray(state[f"{name}.bn.weight"], np.float32)
        beta = np.asarray(state[f"{name}.bn.bias"], np.float32)
        mu = np.asarray(state[f"{name}.bn.running_mean"], np.float32)
        var = np.asarray(state[f"{name}.bn.running_var"], np.float32)
        s = g / np.sqrt(var + eps)
        params[name] = {"w": torch.as_tensor(w * s[:, None, None, None, None], dtype=dtype, device=device),
                        "b": torch.as_tensor(beta - mu * s, dtype=dtype, device=device)}
    params["logits"] = {
        "w": torch.as_tensor(np.asarray(state["logits.conv3d.weight"], np.float32), dtype=dtype, device=device),
        "b": torch.as_tensor(np.asarray(state["logits.conv3d.bias"]), dtype=dtype, device=device),
    }
    return params


def _same_pad(x: torch.Tensor, k, s, value: float = 0.0) -> torch.Tensor:
    """TF/XLA "SAME" padding of an NCDHW tensor for window ``k`` and stride
    ``s``: out = ceil(n / s), total = max((out - 1) s + k - n, 0), split
    total // 2 before and the rest after."""
    pads = []
    for n, kk, ss in reversed(list(zip(x.shape[2:], k, s))):
        total = max((-(-n // ss) - 1) * ss + kk - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def _unit(params, name, x, relu=True):
    _, _, k, stride = I3D_UNITS[name]
    p = params[name]
    y = F.conv3d(_same_pad(x, k, stride), p["w"].float(), p["b"].float(), stride=stride)
    return F.relu(y) if relu else y


def _maxpool(x, k, s):
    return F.max_pool3d(_same_pad(x, k, s, float("-inf")), k, s)


def _mixed(params, prefix, x):
    b0 = _unit(params, f"{prefix}.b0", x)
    b1 = _unit(params, f"{prefix}.b1b", _unit(params, f"{prefix}.b1a", x))
    b2 = _unit(params, f"{prefix}.b2b", _unit(params, f"{prefix}.b2a", x))
    b3 = _unit(params, f"{prefix}.b3b", _maxpool(x, (3, 3, 3), (1, 1, 1)))
    return torch.cat([b0, b1, b2, b3], dim=1)


@torch.no_grad()
def i3d_features(params, videos: torch.Tensor, *, pre_logits: bool = False) -> torch.Tensor:
    """(B, T, 224, 224, 3) in [-1, 1] -> (B, 400) FVD features;
    ``pre_logits=True`` returns the 1024-d pooled trunk features instead."""
    x = videos.float().permute(0, 4, 1, 2, 3).contiguous()
    with fp32_convs():
        x = _unit(params, "Conv3d_1a_7x7", x)
        x = _maxpool(x, (1, 3, 3), (1, 2, 2))
        x = _unit(params, "Conv3d_2c_3x3", _unit(params, "Conv3d_2b_1x1", x))
        x = _maxpool(x, (1, 3, 3), (1, 2, 2))
        x = _mixed(params, "Mixed_3c", _mixed(params, "Mixed_3b", x))
        x = _maxpool(x, (3, 3, 3), (2, 2, 2))
        for m in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = _mixed(params, m, x)
        x = _maxpool(x, (2, 2, 2), (2, 2, 2))
        x = _mixed(params, "Mixed_5c", _mixed(params, "Mixed_5b", x))
        # (2, 7, 7) VALID average, then the 1x1x1 logits and the mean over
        # time and space (pytorch-i3d's forward)
        x = F.avg_pool3d(x, (2, 7, 7), 1)
        if pre_logits:
            return torch.mean(x, dim=(2, 3, 4))
        x = F.conv3d(x, params["logits"]["w"].float(), params["logits"]["b"].float())
    return torch.mean(x, dim=(2, 3, 4))
