"""Measurement scripts of the port; each runs on one GPU."""
