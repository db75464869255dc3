from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref)

__all__ = ["flash_attention", "flash_attention_bwd_ref",
           "flash_attention_fwd_ref"]
