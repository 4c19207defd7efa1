from optical_flow_tpu_torch.viz.flow_color import compute_color, flow_to_color, make_colorwheel
from optical_flow_tpu_torch.viz.plot_flow import plot_flow

__all__ = ["flow_to_color", "make_colorwheel", "compute_color", "plot_flow"]
