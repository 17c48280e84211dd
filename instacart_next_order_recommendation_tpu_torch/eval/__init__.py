"""Retrieval evaluation: IR metrics and the batch evaluator."""
