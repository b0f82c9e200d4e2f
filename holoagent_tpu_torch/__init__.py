"""holoagent_tpu_torch: the PyTorch/CUDA port of holoagent_tpu for one NVIDIA
H100.

The module layout mirrors the JAX package: ``holoagent_tpu_torch/<path>.py``
is the counterpart of ``holoagent_tpu/<path>.py``.  The port imports torch,
numpy and the standard library only, never JAX or the JAX package.  Its
entry points run on the card unless the caller passes ``device="cpu"``.
The two Pallas attention kernels of the mapping path are hand-written CUDA
C++ for Hopper (``csrc/flash_attention.cu``), built with nvcc at first use.
"""

__version__ = "0.1.0"
