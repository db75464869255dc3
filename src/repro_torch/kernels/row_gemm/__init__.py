"""Row-invariant matrix product of the engine path."""
