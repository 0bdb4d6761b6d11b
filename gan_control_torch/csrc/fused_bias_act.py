"""Triton kernels: ``scale * leaky_relu(x + bias)`` over a channel-last
tensor, and its gradient.

``bias_act_kernel`` replaces the Pallas ``fused_bias_act`` /
``_bias_act_kernel`` (gan_control_tpu/ops/pallas_kernels.py:80-117), which
tiled ``[rows, C]`` into 256-row VMEM blocks. ``bias_act_grad_kernel`` is
its backward, which the JAX package left to XLA's autodiff of that op:
``(x + b >= 0 ? scale : scale * slope) * (g + gb)``. With ``gb = 0`` it is
``dx``; with ``gb`` the upstream gradient of the bias gradient it is the
second-order ``d(dy)``, so one kernel serves every order. The mask is
``x + b >= 0`` computed in f32 exactly as the forward computes it, which is
JAX's ``y >= 0`` (true at 0 and at -0.0).

Bound on an H100: device-memory bytes. Per element the forward loads ``x``
once and stores ``y`` once, the gradient loads ``g`` and ``x`` and stores
``dx``; each does a handful of float operations, far below the ~20
operations per byte where the H100's f32 units become the limit. The
design therefore makes one pass over the flat physical buffer: each
program takes a contiguous block of ``BLOCK`` elements, so the loads and
stores are coalesced and vectorised by Triton's masked block accesses; the
channel of an element is ``offset % C`` (the channel is the innermost
physical axis, NHWC or ``[rows, C]``), and the ``C``-float bias vectors stay
in L1/L2. No shared memory and no tensor cores are involved. Arithmetic is
in f32 whatever the storage type (f32 or bf16).

This file is loaded by ``gan_control_torch.ops.kernels`` at the first launch
on a CUDA tensor; it imports ``triton`` and so is never imported on a box
without it.
"""

import triton
import triton.language as tl


@triton.jit
def bias_act_kernel(x_ptr, b_ptr, o_ptr, n, c, negative_slope, scale,
                    BLOCK: tl.constexpr):
    pid = tl.program_id(0).to(tl.int64)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + offs % c, mask=mask, other=0.0)
    y = x + b
    y = tl.where(y >= 0, y, y * negative_slope) * scale
    tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)


@triton.jit
def bias_act_grad_kernel(g_ptr, gb_ptr, x_ptr, b_ptr, o_ptr, n, c, scale_pos,
                         scale_neg, BLOCK: tl.constexpr):
    pid = tl.program_id(0).to(tl.int64)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    ch = offs % c
    g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    gb = tl.load(gb_ptr + ch, mask=mask, other=0.0)
    x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + ch, mask=mask, other=0.0)
    gain = tl.where(x + b >= 0, scale_pos, scale_neg)
    tl.store(o_ptr + offs, (gain * (g + gb)).to(o_ptr.dtype.element_ty), mask=mask)
