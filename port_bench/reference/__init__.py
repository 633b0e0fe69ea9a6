"""Plain PyTorch references, one module per configuration family; each
imports nothing but torch."""
