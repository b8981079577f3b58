"""The multi-bit TFHE scheme in PyTorch; torus values are int64 bits."""
