"""Models of the port (the DLRM so far)."""
