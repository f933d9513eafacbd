"""Host-side event IO for the port (copies of the JAX package's numpy code)."""
