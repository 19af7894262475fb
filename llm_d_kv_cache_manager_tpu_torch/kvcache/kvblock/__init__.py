"""Block keys, the block index contract and its in-memory backend."""
