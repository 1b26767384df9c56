"""Serving steps of the LM zoo (``engine``)."""
