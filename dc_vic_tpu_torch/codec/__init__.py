"""Entropy models, stream container and the compressai-format codec driver."""
