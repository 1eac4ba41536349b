"""The plain reference that decides ``correct``: plain PyTorch, fp32 with
TF32 off, importing nothing of the program, of JAX or of the JAX package."""
