"""PyTorch modules of the acoustic model and the vocoder."""
