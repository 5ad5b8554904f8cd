"""Published peaks of the cards the benchmark knows, by
``torch.cuda.get_device_name()``: NVIDIA's data sheet, dense rates without
sparsity, at the full power limit (700 W for the SXM H100).  Readers take
the entries they need; a kernel bound by memory takes ``hbm_bytes_per_s``."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp8_flops": 1979e12, "int8_ops": 1979e12, "tf32_flops": 495e12,
                              "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str):
    """The card's peaks, or None for a card not in the table (a reader then
    reports no share of a peak)."""
    return PEAKS.get(device_name)
