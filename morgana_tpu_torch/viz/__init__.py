"""Synthesis and analysis helpers of the port: MLPG (``synthesis``) and the
per-utterance feature dumps of the analysis hooks (``io``)."""
