"""Published peaks of the cards the benchmark runs on, by ``torch.cuda.get_device_name()``.

NVIDIA's H100 SXM data sheet: 67 TFLOP/s in float32 outside the tensor
cores and 3.35 TB/s of HBM3, at the full 700 W power limit.  A card that
is not listed has no peak here, and its rooflines are not reported.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peak_of(kind: str):
    return PEAKS.get(kind)
