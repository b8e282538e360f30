"""Command-line twins of the repository's Wan examples, run as
``python -m fairygen_tpu_torch.examples.<name>``."""
