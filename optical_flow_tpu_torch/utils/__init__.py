from optical_flow_tpu_torch.utils.compat import fspecial_gaussian, matlab_round, rgb2gray, rgb2lab, scale_image
from optical_flow_tpu_torch.utils.warmup import warmup_classic_nl  # noqa: F401  (not in __all__, as in the JAX package)

__all__ = [
    "scale_image",
    "fspecial_gaussian",
    "matlab_round",
    "rgb2gray",
    "rgb2lab",
]
