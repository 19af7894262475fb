"""KV-block index, token hashing and pod scoring (copied from the reference)."""
