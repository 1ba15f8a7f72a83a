"""Entry points of the port that run as programs (``python -m``)."""
