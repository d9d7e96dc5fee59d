"""Measurement entry points of the port (run on the card)."""
