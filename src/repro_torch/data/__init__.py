"""Synthetic corpora (``data.synthetic``) and the synthetic token stream
(``data.pipeline``)."""
