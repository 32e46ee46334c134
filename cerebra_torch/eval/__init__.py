"""Retrieval evaluation."""
