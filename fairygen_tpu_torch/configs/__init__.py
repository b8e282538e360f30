"""Data files of the port: ``model_registry.json``, the hash -> model table
(a copy of the JAX package's, held byte-equal to it by a test)."""
