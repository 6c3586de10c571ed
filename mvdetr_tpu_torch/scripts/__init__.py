"""Entry points of the port that are run as scripts (``python -m``)."""
