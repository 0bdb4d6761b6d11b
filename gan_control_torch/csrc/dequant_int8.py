"""Triton kernel: the int8 store of the frozen predictor battery, dequantised
in one launch.

The JAX package stores the battery in int8 under ``predictor_dtype:
"int8"`` (``gan_control_tpu/losses/registry.py:133-161``): each floating
tensor ``x`` becomes ``q = round(x / s)`` with one f32 scale ``s = max|x| /
127``, and every step dequantises it as ``(q.astype(f32) * s).astype(bf16)``,
an XLA convert per tensor (no Pallas kernel). The port keeps every quantised
tensor of the battery in one flat int8 buffer
(``gan_control_torch/losses/int8_storage.py``), each tensor's segment
starting at a multiple of ``BLOCK`` elements and padded with zeros to one,
so that a block never straddles two tensors. ``block_tensor[b]`` is the
tensor of block ``b``: each program loads it and that tensor's scale, then
its ``BLOCK`` int8 values, and stores ``(q * s)`` in the output's type,
rounded to nearest even (Triton's default for a narrowing float cast), the
same rounding as the JAX convert and ``torch.Tensor.to``.

Bound on an H100: device-memory bytes. Per element one byte is read and two
(bf16) are written, with one multiply: far below the operations per byte
where the f32 units become the limit. The loads and stores of a block are
contiguous and unmasked (the buffer is a whole number of blocks), so they
are coalesced and vectorised; no shared memory and no tensor cores.

This file is loaded by ``gan_control_torch.ops.kernels`` at the first launch
on a CUDA tensor; it imports ``triton`` and so is never imported on a box
without it.
"""

import triton
import triton.language as tl


@triton.jit
def dequant_int8_kernel(q_ptr, s_ptr, t_ptr, o_ptr, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    scale = tl.load(s_ptr + tl.load(t_ptr + pid))
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    q = tl.load(q_ptr + offs).to(tl.float32)
    tl.store(o_ptr + offs, (q * scale).to(o_ptr.dtype.element_ty))
