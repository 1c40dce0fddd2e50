"""Collectives of the port at one card (TP = 1)."""
