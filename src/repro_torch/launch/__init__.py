"""Step builders and the serving driver (the JAX package's
``repro.launch``, prefill and decode of dense models only)."""
