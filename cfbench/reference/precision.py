"""The arithmetic a reference runs in."""

from __future__ import annotations

import torch

#: the largest finite float8 e4m3 value
FP8_MAX = 448.0


def fp32_matmuls() -> None:
    """Every float32 product in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    """``fp32``: the reference.  ``fp8``: the check's control, the reference
    one precision below the bfloat16 the configurations state: every
    operand of a matrix product or convolution (weights, activations, q, k,
    v) rounded to float8 e4m3 with one scale per tensor, products and sums
    still in float32."""

    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.name == "fp32":
            return t
        scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale
