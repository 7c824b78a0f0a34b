"""Synthesis helpers of the port (MLPG over feature streams)."""
