"""Shared utilities: colored logging, YAML config loading, path resolution."""
