"""The port's hand-written Hopper kernels (``csrc/``), each beside its
plain PyTorch version.  ROADMAP.md queue 2 lists the TPU kernels still to
port."""
