from optical_flow_tpu_torch.evaluation.metrics import flow_angular_error

__all__ = ["flow_angular_error"]
