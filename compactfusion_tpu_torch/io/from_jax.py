"""Carry parameters from the JAX package into the port.

``params_from_numpy`` takes the JAX package's parameter tree with numpy
leaves (``jax.tree_util.tree_map(np.asarray, params)``) and returns the same
tree of torch tensors: dicts stay dicts (the stacked leading layer axis of
``init_pixart``, ``init_flux``, ``init_cogvideox`` and ``init_stepvideo``
included, Step-Video's head-axis projections in their (d, n, H, hd) and
(H, hd, d) layouts), lists stay
lists (the up blocks and their resnets of the 2D and the 3D VAE).  The
eval extractors keep PyTorch's conv layout where the JAX package keeps
HWIO / DHWIO: :func:`conv_tree_from_jax` carries the trees of ``init_vgg16``,
``init_inception_v3`` and ``init_i3d`` across with every conv weight moved
to OIHW / OIDHW.  This module imports neither jax nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects the ml_dtypes bfloat16 dtype: reinterpret
        # the bits as uint16 and view them back as torch.bfloat16
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cpu", dtype=None):
    """Numpy (or array-like) parameter tree -> torch tree on ``device``.
    ``dtype`` casts floating-point leaves when given."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    return _to_tensor(tree, device, dtype)


def conv_tree_from_jax(tree, device="cpu", dtype=None):
    """{name: {"w": (*k, I, O), "b": (O,)}} -> the same tree of tensors with
    each weight in PyTorch's (O, I, *k) layout: the JAX trees of
    ``eval.vgg`` (HWIO), ``eval.inception`` (HWIO, BatchNorm folded) and
    ``eval.i3d`` (DHWIO, BatchNorm folded; ``logits`` a 1x1x1 conv)."""
    out = {}
    for name, p in tree.items():
        w = np.asarray(p["w"])
        order = (w.ndim - 1, w.ndim - 2) + tuple(range(w.ndim - 2))
        out[name] = {"w": _to_tensor(np.ascontiguousarray(np.transpose(w, order)), device, dtype),
                     "b": _to_tensor(p["b"], device, dtype)}
    return out
