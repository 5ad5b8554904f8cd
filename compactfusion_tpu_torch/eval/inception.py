"""InceptionV3 pool-feature extractor for FID (counterpart of
``compactfusion_tpu/eval/inception.py``).

torchvision's ``inception_v3`` trunk up to the global average pool (2048-d
features), with torchvision's semantics, not pytorch-fid's (pytorch-fid
patches the A/C/E branch pools to ``count_include_pad=False`` and makes
Mixed_7c's pool branch a max-pool; its ``pt_inception-2015-12-05`` weights
are not drop-in).  The converter folds each eval-mode BatchNorm (eps 1e-3)
into its conv at load time, as the JAX package's does; weights stay in
PyTorch's OIHW layout and run as cuDNN convs with TF32 off.
``io/from_jax.py::conv_tree_from_jax`` takes the JAX package's HWIO tree
across.

Local-weights path: export torchvision's ``inception_v3_google-0cc3c7bd.pth``
to safetensors or npz on a connected machine; ``params =
convert_inception_v3(load_safetensors(path))``; ``feats =
inception_pool_features(params, images)`` with images (B, 299, 299, 3) in
[-1, 1]; then ``metrics.fid_from_features``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from compactfusion_tpu_torch.eval.metrics import fp32_convs

#: every BasicConv2d: (name, in, out, (kh, kw), stride, (ph, pw)); the
#: converter and the random init share this table, the forward wires the
#: topology explicitly
INCEPTION_CONVS = []


def _cv(name, c_in, c_out, k, stride=1, pad=(0, 0)):
    kh, kw = (k, k) if isinstance(k, int) else k
    INCEPTION_CONVS.append((name, c_in, c_out, (kh, kw), stride, pad))


_cv("Conv2d_1a_3x3", 3, 32, 3, 2)
_cv("Conv2d_2a_3x3", 32, 32, 3)
_cv("Conv2d_2b_3x3", 32, 64, 3, 1, (1, 1))
_cv("Conv2d_3b_1x1", 64, 80, 1)
_cv("Conv2d_4a_3x3", 80, 192, 3)


def _inception_a(prefix, c_in, pool):
    _cv(f"{prefix}.branch1x1", c_in, 64, 1)
    _cv(f"{prefix}.branch5x5_1", c_in, 48, 1)
    _cv(f"{prefix}.branch5x5_2", 48, 64, 5, 1, (2, 2))
    _cv(f"{prefix}.branch3x3dbl_1", c_in, 64, 1)
    _cv(f"{prefix}.branch3x3dbl_2", 64, 96, 3, 1, (1, 1))
    _cv(f"{prefix}.branch3x3dbl_3", 96, 96, 3, 1, (1, 1))
    _cv(f"{prefix}.branch_pool", c_in, pool, 1)
    return 64 + 64 + 96 + pool


def _inception_b(prefix, c_in):
    _cv(f"{prefix}.branch3x3", c_in, 384, 3, 2)
    _cv(f"{prefix}.branch3x3dbl_1", c_in, 64, 1)
    _cv(f"{prefix}.branch3x3dbl_2", 64, 96, 3, 1, (1, 1))
    _cv(f"{prefix}.branch3x3dbl_3", 96, 96, 3, 2)
    return 384 + 96 + c_in


def _inception_c(prefix, c_in, c7):
    _cv(f"{prefix}.branch1x1", c_in, 192, 1)
    _cv(f"{prefix}.branch7x7_1", c_in, c7, 1)
    _cv(f"{prefix}.branch7x7_2", c7, c7, (1, 7), 1, (0, 3))
    _cv(f"{prefix}.branch7x7_3", c7, 192, (7, 1), 1, (3, 0))
    _cv(f"{prefix}.branch7x7dbl_1", c_in, c7, 1)
    _cv(f"{prefix}.branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0))
    _cv(f"{prefix}.branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3))
    _cv(f"{prefix}.branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0))
    _cv(f"{prefix}.branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3))
    _cv(f"{prefix}.branch_pool", c_in, 192, 1)
    return 768


def _inception_d(prefix, c_in):
    _cv(f"{prefix}.branch3x3_1", c_in, 192, 1)
    _cv(f"{prefix}.branch3x3_2", 192, 320, 3, 2)
    _cv(f"{prefix}.branch7x7x3_1", c_in, 192, 1)
    _cv(f"{prefix}.branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3))
    _cv(f"{prefix}.branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0))
    _cv(f"{prefix}.branch7x7x3_4", 192, 192, 3, 2)
    return 320 + 192 + c_in


def _inception_e(prefix, c_in):
    _cv(f"{prefix}.branch1x1", c_in, 320, 1)
    _cv(f"{prefix}.branch3x3_1", c_in, 384, 1)
    _cv(f"{prefix}.branch3x3_2a", 384, 384, (1, 3), 1, (0, 1))
    _cv(f"{prefix}.branch3x3_2b", 384, 384, (3, 1), 1, (1, 0))
    _cv(f"{prefix}.branch3x3dbl_1", c_in, 448, 1)
    _cv(f"{prefix}.branch3x3dbl_2", 448, 384, 3, 1, (1, 1))
    _cv(f"{prefix}.branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1))
    _cv(f"{prefix}.branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0))
    _cv(f"{prefix}.branch_pool", c_in, 192, 1)
    return 320 + 768 + 768 + 192


_c = _inception_a("Mixed_5b", 192, 32)
_c = _inception_a("Mixed_5c", _c, 64)
_c = _inception_a("Mixed_5d", _c, 64)
_c = _inception_b("Mixed_6a", _c)
_c = _inception_c("Mixed_6b", _c, 128)
_c = _inception_c("Mixed_6c", _c, 160)
_c = _inception_c("Mixed_6d", _c, 160)
_c = _inception_c("Mixed_6e", _c, 192)
_c = _inception_d("Mixed_7a", _c)
_c = _inception_e("Mixed_7b", _c)
FEATURE_DIM = _inception_e("Mixed_7c", _c)
assert FEATURE_DIM == 2048

_CONV_TABLE = {t[0]: t for t in INCEPTION_CONVS}


def init_inception_v3(generator: torch.Generator, dtype=torch.float32) -> Dict[str, Any]:
    """Random weights with the torchvision topology (truncated normal at
    fan-in scale, zero biases), drawn on the generator's device."""
    dev = generator.device
    params = {}
    for name, c_in, c_out, (kh, kw), _, _ in INCEPTION_CONVS:
        w = torch.nn.init.trunc_normal_(torch.empty(c_out, c_in, kh, kw, device=dev), generator=generator)
        params[name] = {"w": (w * (kh * kw * c_in) ** -0.5).to(dtype),
                        "b": torch.zeros(c_out, dtype=dtype, device=dev)}
    return params


def convert_inception_v3(state: Dict[str, np.ndarray], dtype=torch.float32, eps: float = 1e-3, device="cuda"):
    """torchvision ``inception_v3`` state dict -> param tree (OIHW) with the
    eval-mode BatchNorm folded into each conv (w' = w g / sqrt(v + eps),
    b' = beta - mean g / sqrt(v + eps)), in numpy fp32 as the JAX
    package folds it; on ``device`` (the card unless the caller asks for
    the CPU)."""
    params = {}
    for name, *_ in INCEPTION_CONVS:
        w = np.asarray(state[f"{name}.conv.weight"], np.float32)  # (O, I, kh, kw)
        g = np.asarray(state[f"{name}.bn.weight"], np.float32)
        beta = np.asarray(state[f"{name}.bn.bias"], np.float32)
        mu = np.asarray(state[f"{name}.bn.running_mean"], np.float32)
        var = np.asarray(state[f"{name}.bn.running_var"], np.float32)
        s = g / np.sqrt(var + eps)
        params[name] = {"w": torch.as_tensor(w * s[:, None, None, None], dtype=dtype, device=device),
                        "b": torch.as_tensor(beta - mu * s, dtype=dtype, device=device)}
    return params


def _conv(params, name, x):
    _, _, _, _, stride, pad = _CONV_TABLE[name]
    p = params[name]
    return F.relu(F.conv2d(x, p["w"].float(), p["b"].float(), stride=stride, padding=pad))


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)


def _avgpool3(x):
    """avg_pool2d(3, stride 1, padding 1) with count_include_pad (JAX: the
    window sum over zero padding / 9)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _block_a(params, prefix, x):
    b1 = _conv(params, f"{prefix}.branch1x1", x)
    b5 = _conv(params, f"{prefix}.branch5x5_2", _conv(params, f"{prefix}.branch5x5_1", x))
    b3 = x
    for i in (1, 2, 3):
        b3 = _conv(params, f"{prefix}.branch3x3dbl_{i}", b3)
    bp = _conv(params, f"{prefix}.branch_pool", _avgpool3(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _block_b(params, prefix, x):
    b3 = _conv(params, f"{prefix}.branch3x3", x)
    bd = x
    for i in (1, 2, 3):
        bd = _conv(params, f"{prefix}.branch3x3dbl_{i}", bd)
    return torch.cat([b3, bd, _maxpool(x)], dim=1)


def _block_c(params, prefix, x):
    b1 = _conv(params, f"{prefix}.branch1x1", x)
    b7 = x
    for i in (1, 2, 3):
        b7 = _conv(params, f"{prefix}.branch7x7_{i}", b7)
    bd = x
    for i in (1, 2, 3, 4, 5):
        bd = _conv(params, f"{prefix}.branch7x7dbl_{i}", bd)
    bp = _conv(params, f"{prefix}.branch_pool", _avgpool3(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _block_d(params, prefix, x):
    b3 = _conv(params, f"{prefix}.branch3x3_2", _conv(params, f"{prefix}.branch3x3_1", x))
    b7 = x
    for i in (1, 2, 3, 4):
        b7 = _conv(params, f"{prefix}.branch7x7x3_{i}", b7)
    return torch.cat([b3, b7, _maxpool(x)], dim=1)


def _block_e(params, prefix, x):
    b1 = _conv(params, f"{prefix}.branch1x1", x)
    b3 = _conv(params, f"{prefix}.branch3x3_1", x)
    b3 = torch.cat([_conv(params, f"{prefix}.branch3x3_2a", b3), _conv(params, f"{prefix}.branch3x3_2b", b3)], dim=1)
    bd = _conv(params, f"{prefix}.branch3x3dbl_2", _conv(params, f"{prefix}.branch3x3dbl_1", x))
    bd = torch.cat([_conv(params, f"{prefix}.branch3x3dbl_3a", bd), _conv(params, f"{prefix}.branch3x3dbl_3b", bd)],
                   dim=1)
    bp = _conv(params, f"{prefix}.branch_pool", _avgpool3(x))
    return torch.cat([b1, b3, bd, bp], dim=1)


@torch.no_grad()
def inception_pool_features(params, images: torch.Tensor) -> torch.Tensor:
    """(B, 299, 299, 3) in [-1, 1] -> (B, 2048) pool features (fp32)."""
    x = images.float().permute(0, 3, 1, 2).contiguous()
    with fp32_convs():
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = _conv(params, name, x)
        x = _maxpool(x)
        x = _conv(params, "Conv2d_4a_3x3", _conv(params, "Conv2d_3b_1x1", x))
        x = _maxpool(x)
        for m in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = _block_a(params, m, x)
        x = _block_b(params, "Mixed_6a", x)
        for m in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = _block_c(params, m, x)
        x = _block_d(params, "Mixed_7a", x)
        x = _block_e(params, "Mixed_7b", x)
        x = _block_e(params, "Mixed_7c", x)
    return torch.mean(x, dim=(2, 3))
