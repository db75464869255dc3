from repro_torch.engine.engine import (BlobCorruptionError, EngineSeq,
                                       Instance, KVBlob, StepFunctions,
                                       StepTicket)
from repro_torch.engine.sampling import (draft_acceptance, position_keys,
                                         sample_tokens, token_logprobs_at,
                                         tree_acceptance)
from repro_torch.engine.token_tree import (TokenTree, build_token_tree,
                                           chain_tree)

__all__ = ["BlobCorruptionError", "EngineSeq", "Instance", "KVBlob",
           "StepFunctions", "StepTicket", "draft_acceptance",
           "position_keys", "sample_tokens", "token_logprobs_at",
           "tree_acceptance", "TokenTree", "build_token_tree", "chain_tree"]
