"""Synthetic, deterministic data streams (numpy only)."""
