"""Parameter-tree core: host RNG, trace context and the tree nodes."""
