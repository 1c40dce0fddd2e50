"""Synthetic id sampling shared by the traffic scenarios."""
