"""Utilities of the port: temporal tiling, tokenizers, media IO."""
