"""Model and serve configurations of the PyTorch port."""
