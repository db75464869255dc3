"""Row reductions of the engine path (RMSNorm, logits' log-sum-exp),
row-invariant on the card."""
