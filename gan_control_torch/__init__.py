"""gan_control_torch — PyTorch/CUDA port of gan_control_tpu for NVIDIA Hopper.

Same layout and public API as the JAX package (NHWC images, latents
``[B, 512]`` / ``[B, L, 512]``, the model-directory and msgpack checkpoint
formats), with PyTorch idiom inside: ``nn.Module``s, an explicit ``device``
argument, and ``torch.Generator``s in place of ``jax.random`` keys.

Every TPU kernel of the JAX package is a kernel written for Hopper
(``ops/kernels.py``, ``csrc/``): ``fused_bias_act`` and its gradient in
Triton, ``blur2x_up``, ``blur2x_down`` and ``blur_sep`` in CUDA C++, each
with an autograd Function whose backward is a kernel too. On a CPU tensor
each wrapper runs its plain PyTorch version; on a CUDA tensor it launches
the kernel.

Ported: controlled generation (``inference``), and phase-1 training
(``training``, ``trainers``, the ``train_generator`` command line) from
image folders (``data``) with the contrastive attribute losses of the FFHQ
configuration (``losses``: the criterion, the registry and six frozen
predictors, which take the reference checkpoints' ``state_dict`` names and
run on cuDNN), both mini-batch modes, sample images (``evaluation``) and
whole-state checkpoints that either package resumes; phase 2 (the
attribute sweep and controller training); serving (``inference.serving``:
one CUDA graph per group set and batch bucket, ``torch.export`` artifacts
served without the model code) and group interpolation. Not yet: the AFHQ
and MetFaces predictors, ADA, transfer learning, evaluation, multi-card
serving.

The package imports neither JAX nor ``gan_control_tpu``.
"""

__version__ = "0.1.0"
