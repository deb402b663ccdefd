"""The port's command-line stages (``python -m l3embedding_torch.cli.<stage>``)."""
