from optical_flow_tpu_torch.methods.base import BaseOpticalFlow
from optical_flow_tpu_torch.methods.hs import HSOpticalFlow
from optical_flow_tpu_torch.methods.ba import BAOpticalFlow
from optical_flow_tpu_torch.methods.classic_nl import ClassicNLOpticalFlow
from optical_flow_tpu_torch.methods.alt_ba import AltBAOpticalFlow

__all__ = [
    "BaseOpticalFlow",
    "HSOpticalFlow",
    "BAOpticalFlow",
    "ClassicNLOpticalFlow",
    "AltBAOpticalFlow",
]
