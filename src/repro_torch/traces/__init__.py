"""Synthetic traffic scenarios (numpy; identical ids to the reference)."""
