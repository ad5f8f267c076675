"""Constants, vocabularies and the default device: the port's own, free
of JAX."""
