"""nesie_tpu_torch: the PyTorch + CUDA port of nesie_tpu for NVIDIA Hopper.

Mirrors the module tree of ``nesie_tpu``: the flagship detector's eval
path and its supervised and teacher-student training steps. Plain tensor
code is PyTorch; FPS (each row held on chip on one CTA or a cluster), ball
query and three-NN are CUDA kernels written for ``sm_90a`` (``csrc/``),
each with a plain PyTorch version beside it that CPU tensors take. The
package never imports jax.
"""

__version__ = "0.1.0"
