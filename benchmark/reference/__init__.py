"""The plain reference of the training step: plain PyTorch in f32, with TF32
off, independent of the program under test.

It is a frozen copy of the port's eager step (ray sampling, the renderer
with its up-sampling, the nets, the strip sampler's plain version, the
losses and Adam leaf by leaf), with the kernels K1, K2 and K3 replaced by
their plain formulas and every network product in f32. It imports nothing
of the port nor of JAX, and nothing here reads what the port made: the
harness hands it the seeded weights, the draws and the scene's raw files.
"""
