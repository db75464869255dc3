from repro_torch.models.transformer import (cache_len_for, forward,
                                            init_cache, init_params)

__all__ = ["cache_len_for", "forward", "init_cache", "init_params"]
