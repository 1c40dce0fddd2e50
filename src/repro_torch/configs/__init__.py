"""Model configurations of the port (DLRM so far): pure data, copied from
``repro/configs`` so the port never imports the JAX package."""
