from repro_torch.kernels.spec_verify.ops import spec_verify
from repro_torch.kernels.spec_verify.ref import spec_verify_ref

__all__ = ["spec_verify", "spec_verify_ref"]
