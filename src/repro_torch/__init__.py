"""PyTorch/CUDA port of the RAR system (``src/repro`` is the JAX
reference). Module names follow the JAX package's; entry points take
``device=`` and run on the card unless asked for the CPU."""
