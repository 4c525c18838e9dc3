"""Hand-written Hopper kernels, their plain PyTorch versions (``ref``) and
the device dispatch (``ops``)."""
