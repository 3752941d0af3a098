"""xvr_tpu_torch: the PyTorch/CUDA port of xvr_tpu, for NVIDIA Hopper GPUs.

A second package beside the JAX reference ``xvr_tpu``, with the same layout
and public names. Plain tensor code is PyTorch; the kernels of the
shear-warp and slab-march renderers are hand-written CUDA (``csrc/``), built
on first use. Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run instead. The
package never imports JAX or ``xvr_tpu``.
"""

__version__ = "0.1.0"
