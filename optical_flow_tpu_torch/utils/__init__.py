from optical_flow_tpu_torch.utils.compat import fspecial_gaussian, matlab_round, rgb2gray, rgb2lab, scale_image

__all__ = [
    "scale_image",
    "fspecial_gaussian",
    "matlab_round",
    "rgb2gray",
    "rgb2lab",
]
