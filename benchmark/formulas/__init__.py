"""Frozen operation and byte counts, one file a kernel or attention mode, and the card's peaks."""
