from .ops import ssm_scan, ssm_scan_fwd, ssm_scan_state
from .ref import selective_scan_ref, selective_scan_tiled_ref

__all__ = ["ssm_scan", "ssm_scan_fwd", "ssm_scan_state",
           "selective_scan_ref", "selective_scan_tiled_ref"]
