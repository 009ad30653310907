"""PyTorch and CUDA port of the A2CiD2 reproduction, for NVIDIA Hopper.

The JAX package ``repro`` is the reference this package is held against;
the port never imports it, nor JAX.  Layout mirrors it: ``core`` (graphs,
event schedules, the A2CiD2 dynamics, flat buffers, the event engine and
the simulator), ``kernels`` (hand-written CUDA kernels with their plain
PyTorch versions), ``models`` (ResNet, the dense transformer family),
``configs`` (the architecture registry), ``data`` and ``launch`` (the
prefill step and the training launcher).  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
