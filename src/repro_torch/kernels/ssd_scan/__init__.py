from repro_torch.kernels.ssd_scan.ops import ssd_chunk_scan
from repro_torch.kernels.ssd_scan.ref import ssd_ref

__all__ = ["ssd_chunk_scan", "ssd_ref"]
