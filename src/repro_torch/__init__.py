"""PyTorch and CUDA port of the multivariate geostatistics package.

The module tree mirrors ``repro`` (the JAX reference): ``core/``,
``checkpointing/``, ``distribution/``, ``kernels/``, ``launch/`` (device
meshes and rank processes), ``serving/``,
``testing/`` (fault injection) and, for the LM substrate, ``configs/`` and
``models/`` hold the counterparts of the functions of the same names there.  The port imports ``torch`` and ``numpy`` only.

Entry points that take numpy arrays run on the CUDA device unless the caller
passes ``device="cpu"``; with no CUDA device and no explicit device they
raise.  Functions that take tensors run where their tensors lie.  The
hand-written kernels (``kernels/csrc/*.cu``) run for CUDA tensors; a CPU
tensor takes each kernel's plain PyTorch version.
"""
