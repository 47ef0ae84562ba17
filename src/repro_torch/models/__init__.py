"""The LLM scaffold's models on torch: layers, GQA attention and the dense
decoder stack (the JAX package's ``repro.models``, dense family only)."""
