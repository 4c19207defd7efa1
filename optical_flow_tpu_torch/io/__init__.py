from optical_flow_tpu_torch.io.flo import read_flo, read_flow_file, write_flo
from optical_flow_tpu_torch.io.png import read_png

__all__ = ["read_flo", "write_flo", "read_flow_file", "read_png"]
