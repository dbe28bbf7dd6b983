"""The benchmark's plain reference: float32 PyTorch with TF32 off, and the
lower-precision controls.  Imports nothing of the program."""
