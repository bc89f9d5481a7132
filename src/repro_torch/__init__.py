"""PyTorch / CUDA port of the FCS serving system (see ROADMAP.md)."""
