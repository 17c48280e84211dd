"""Serving: the fused ids -> top-k pipeline and the Recommender."""
