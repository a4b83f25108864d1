"""Mamba-1 selective scan: CUDA kernel wrapper and its plain version."""
from repro_torch.kernels.ssm_scan.ops import (DEFAULT_BLOCK_D, ssm_scan,
                                              ssm_scan_dispatched,
                                              ssm_scan_scheduled)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

__all__ = ["ssm_scan", "ssm_scan_scheduled", "ssm_scan_dispatched",
           "ssm_scan_ref", "DEFAULT_BLOCK_D"]
