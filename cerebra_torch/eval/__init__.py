"""Retrieval evaluation: exact L2 top-k, recall/precision and the score
artifacts."""
