"""Models of the port: the DLRM, and the hybrid (zamba2) LM's serving half."""
