"""Conv-efficiency ops of the port (counterpart of
paddle_tpu/ops/pallas_conv.py).

- ``stem_space_to_depth``: ResNet's 7x7/s2 stem conv re-laid-out as a 4x4/s1
  conv on a 2x2 space-to-depth grid, the same dot products. A pure XLA
  re-layout in the reference, so torch ops here (pad, reshape, permute, one
  VALID conv).
- ``fused_conv1x1_bn_act``: a 1x1 conv with the folded BatchNorm affine and
  the activation in the epilogue, ``act((x . w) * scale + shift)``. The
  reference's one in-repo Pallas kernel (``_pallas_matmul_affine``, K4);
  here the hand-written CUDA kernel of csrc/conv1x1_bn_act.cu on the card
  (:func:`conv1x1_bn_act`), its plain version
  (:func:`fused_conv1x1_bn_act_ref`) on the CPU.

Weights are OIHW, the port's layout (the reference's NHWC weights are HWIO;
convert.py transposes them); activations are NHWC, as the reference's ops
take them.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .nn_ops import _match_weight_dtype
from .registry import register_op

__all__ = ['stem_space_to_depth', 'fused_conv1x1_bn_act',
           'fused_conv1x1_bn_act_ref', 'conv1x1_bn_act', 'conv1x1_plan',
           'conv1x1_kernel_info', 'K4_BODIES', 'K4_WGMMA_TILES']

_ACTS = (None, 'relu')


def stem_space_to_depth(x, weight, *, data_format='NHWC'):
    """``conv2d(x, weight, stride=2, padding=3)`` for a 7x7 OIHW ``weight``
    and NHWC ``x``, through a 2x2 space-to-depth: the weight gets a zero tap
    in front (8x8), its even and odd taps split into the s2d channels (a
    4x4 kernel over 4C channels), and ``x`` is padded (4 in front, enough
    behind to keep the grid even) and folded 2x2 into its channels; one
    stride-1 VALID conv then gives the same dot products. Returns NHWC."""
    if data_format != 'NHWC':
        raise ValueError('stem_space_to_depth requires NHWC')
    if tuple(weight.shape[2:]) != (7, 7):
        raise ValueError(f'stem kernel must be 7x7 OIHW, got '
                         f'{tuple(weight.shape)}')
    x = _match_weight_dtype(x, weight)
    n, h, hw, c = x.shape
    o = weight.shape[0]
    w = weight.permute(2, 3, 1, 0)                 # OIHW -> HWIO
    w8 = F.pad(w, (0, 0, 0, 0, 1, 0, 1, 0))         # zero tap in front
    # W2[tH, tW, rH*2C + rW*C + c, o] = w8[2tH + rH, 2tW + rW, c, o]
    w2 = w8.reshape(4, 2, 4, 2, c, o).permute(0, 2, 1, 3, 4, 5)
    w2 = w2.reshape(4, 4, 4 * c, o).permute(3, 2, 0, 1)   # HWIO -> OIHW
    h_out, w_out = (h - 1) // 2 + 1, (hw - 1) // 2 + 1
    pad_h, pad_w = 2 * h_out + 2 - h, 2 * w_out + 2 - hw
    xp = F.pad(x, (0, 0, 4, pad_w, 4, pad_h))
    h2, w2dim = h_out + 3, w_out + 3
    xs = xp.reshape(n, h2, 2, w2dim, 2, c).permute(0, 1, 3, 2, 4, 5)
    xs = xs.reshape(n, h2, w2dim, 4 * c)           # channel = rH*2C + rW*C + c
    y = F.conv2d(xs.permute(0, 3, 1, 2), w2)       # channels_last view
    return y.permute(0, 2, 3, 1)


def fused_conv1x1_bn_act_ref(x, weight, scale, shift, *, act=None):
    """Plain version of K4, in the kernel's arithmetic (the reference's
    ``_fused_kernel``): the product summed in f32, the affine applied in f32
    to the f32 sum with ``scale`` and ``shift`` as given (already in
    ``x``'s type), the activation, one rounding to ``x``'s type. ``x``
    (B, H, W, C) NHWC, ``weight`` (O, C, 1, 1); returns (B, H, W, O)."""
    b, h, w, c = x.shape
    acc = x.reshape(-1, c).float() @ weight.reshape(-1, c).float().t()
    y = acc * scale.float() + shift.float()
    if act == 'relu':
        y = torch.relu(y)
    return y.to(x.dtype).reshape(b, h, w, -1)


def _check_k4(x, weight, scale, shift):
    """What the kernel takes; raises on anything else."""
    dev = x.device
    for name, t in (('weight', weight), ('scale', scale), ('shift', shift)):
        if t.device != dev:
            raise ValueError(f'{name} is on {t.device}, x on {dev}')
        if t.dtype != x.dtype:
            raise TypeError(f'{name} is {t.dtype}, x is {x.dtype}: the '
                            f'kernel takes one type')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'x must be float32 or bfloat16, got {x.dtype}')
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(
            f'x must be a contiguous (B, H, W, C) tensor (a channels_last '
            f'NCHW tensor passes as x.permute(0, 2, 3, 1)), got shape '
            f'{tuple(x.shape)} strides {x.stride()}')
    c = x.shape[3]
    if (weight.dim() != 4 or tuple(weight.shape[1:]) != (c, 1, 1)
            or not weight.is_contiguous()):
        raise ValueError(f'weight must be a contiguous (O, {c}, 1, 1) '
                         f'tensor, got {tuple(weight.shape)}')
    o = weight.shape[0]
    for name, t in (('scale', scale), ('shift', shift)):
        if tuple(t.shape) != (o,) or not t.is_contiguous():
            raise ValueError(f'{name} must be a contiguous ({o},) tensor, '
                             f'got {tuple(t.shape)}')


# conv1x1_bn_act_plan's body numbers
K4_BODIES = ('wmma', 'wgmma', 'f32')
K4_WGMMA_TILES = (64, 128)


def _k4_library():
    from ._build import library
    return library('conv1x1_bn_act')


def _k4_status(lib, err, what):
    if err != 0:
        msg = lib.conv1x1_bn_act_error_string(err).decode()
        raise RuntimeError(f'{what} failed: CUDA error {err} ({msg})')


def _k4_plan(lib, x, weight, scale, shift, out, m, o, c):
    plan = (ctypes.c_int * 4)()
    _k4_status(lib, lib.conv1x1_bn_act_plan(
        m, o, c, int(x.dtype == torch.bfloat16), x.data_ptr(),
        weight.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        out.data_ptr(), plan), 'conv1x1_bn_act_plan')
    return dict(zip(('body', 'bn', 'grid', 'stages'), plan),
                body=K4_BODIES[plan[0]])


def conv1x1_plan(x, weight, scale, shift):
    """What :func:`conv1x1_bn_act` launches for these CUDA tensors, as the
    launcher chooses it from the type, the shape and the alignment alone:
    ``{'body': 'wgmma' | 'wmma' | 'f32', 'bn': tile columns, 'grid': CTAs,
    'stages': K slices in flight}`` (the output is a fresh, aligned
    tensor)."""
    if x.device.type != 'cuda':
        raise ValueError(f'conv1x1_plan describes a launch on CUDA tensors, '
                         f'x is on {x.device}')
    _check_k4(x, weight, scale, shift)
    b, h, w, c = x.shape
    o = weight.shape[0]
    out = torch.empty((1,), dtype=x.dtype, device=x.device)
    return _k4_plan(_k4_library(), x, weight, scale, shift, out, b * h * w,
                    o, c)


def conv1x1_kernel_info(body, bn=64):
    """What a K4 body (one of :data:`K4_BODIES`; the wgmma body at tile
    columns ``bn`` in :data:`K4_WGMMA_TILES`) was built with, read from the
    loaded library on the current card: ``{'registers', 'spill_bytes',
    'static_smem', 'dynamic_smem', 'ctas_per_sm', 'threads'}``."""
    if body not in K4_BODIES or (body == 'wgmma'
                                 and bn not in K4_WGMMA_TILES):
        raise ValueError(f'no K4 body {body!r} with {bn} tile columns')
    from ._build import kernel_info
    return kernel_info('conv1x1_bn_act', 'conv1x1_bn_act_kernel_info',
                       K4_BODIES.index(body), bn)


def conv1x1_bn_act(x, weight, scale, shift, *, act=None):
    """Launch K4 (csrc/conv1x1_bn_act.cu) on CUDA tensors: the (B, H, W, O)
    NHWC output of ``act((x . w) * scale + shift)``, in ``x``'s type, on the
    current stream. ``x`` contiguous (B, H, W, C), ``weight`` contiguous
    (O, C, 1, 1), ``scale``/``shift`` (O,); all one type, float32 or
    bfloat16. Raises on anything else; the plain version is
    :func:`fused_conv1x1_bn_act_ref`.

    The launcher runs the bf16 wgmma body wherever TMA can describe the
    operands (C and O multiples of 8, aligned bases), the bf16 WMMA body
    elsewhere and the f32 body for f32 (:func:`conv1x1_plan` says which).
    ``conv1x1_bn_act.launches`` counts every launch,
    ``conv1x1_bn_act.launches_wgmma`` those of the wgmma body."""
    if act not in _ACTS:
        raise ValueError(f'act must be None or relu, got {act!r}')
    if x.device.type != 'cuda':
        raise ValueError(f'conv1x1_bn_act launches on CUDA tensors, x is on '
                         f'{x.device}')
    _check_k4(x, weight, scale, shift)
    b, h, w, c = x.shape
    o = weight.shape[0]
    m = b * h * w
    out = torch.empty((b, h, w, o), dtype=x.dtype, device=x.device)
    if m and o:
        lib = _k4_library()
        body = _k4_plan(lib, x, weight, scale, shift, out, m, o, c)['body']
        _k4_status(lib, lib.conv1x1_bn_act(
            x.data_ptr(), weight.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), out.data_ptr(), m, o, c,
            int(x.dtype == torch.bfloat16), int(act == 'relu'),
            torch.cuda.current_stream(x.device).cuda_stream),
            'conv1x1_bn_act kernel launch')
        conv1x1_bn_act.launches += 1
        if body == 'wgmma':
            conv1x1_bn_act.launches_wgmma += 1
    return out


conv1x1_bn_act.launches = 0
conv1x1_bn_act.launches_wgmma = 0


class _FusedConv1x1(torch.autograd.Function):
    """Forward: K4 on the card, the plain version on the CPU. Backward, in
    torch ops (the reference kernel has no backward either; JAX
    differentiates its XLA form): the gradient through the ReLU mask of
    the saved output, then dshift = sum(g), dscale = sum(g * x.w),
    dX = (g * scale) . W and dW = (g * scale)^T . X, all summed in f32."""

    @staticmethod
    def forward(ctx, x, weight, scale, shift, act):
        if x.device.type == 'cuda':
            y = conv1x1_bn_act(x, weight, scale, shift, act=act)
        else:
            y = fused_conv1x1_bn_act_ref(x, weight, scale, shift, act=act)
        ctx.act = act
        ctx.save_for_backward(x, weight, scale, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight, scale, y = ctx.saved_tensors
        c = x.shape[3]
        x2 = x.reshape(-1, c).float()
        w2 = weight.reshape(-1, c).float()
        g = gy.reshape(x2.shape[0], -1).float()
        if ctx.act == 'relu':
            g = g * (y.reshape(g.shape) > 0)
        dshift = g.sum(0)
        dscale = (g * (x2 @ w2.t())).sum(0)
        gs = g * scale.float()
        dx = (gs @ w2).reshape(x.shape)
        dw = (gs.t() @ x2).reshape(weight.shape)
        return (dx.to(x.dtype), dw.to(weight.dtype), dscale.to(scale.dtype),
                dshift.to(scale.dtype), None)


def _unfused(x, weight, scale, shift, *, act=None):
    """The reference's unfused formulation (its ``force_pallas=False``
    branch) in torch ops: the product in ``x``'s type, then the affine in
    ``x``'s type, then the activation; differentiated by autograd."""
    c = x.shape[3]
    y = torch.einsum('nhwc,oc->nhwo', x, weight.reshape(-1, c)) * scale \
        + shift
    return torch.relu(y) if act == 'relu' else y


@register_op('fused_conv1x1_bn_act')
def fused_conv1x1_bn_act(x, weight, scale, shift, *, act=None,
                         data_format='NHWC', force_pallas=None):
    """``act((x . weight) * scale + shift)`` for a 1x1 OIHW ``weight``
    (O, C, 1, 1) and NHWC ``x`` (B, H, W, C); ``scale``/``shift`` are the
    folded BatchNorm affine (gamma / sqrt(var + eps), beta - mean * that),
    inference mode. ``x`` takes the weight's type, and ``scale`` and
    ``shift`` are cast to it, as in the reference. Differentiable in all
    four inputs.

    With ``force_pallas`` None or True it launches K4
    (:func:`conv1x1_bn_act`) on the card and raises on what the kernel does
    not take, and runs :func:`fused_conv1x1_bn_act_ref` on the CPU.
    ``force_pallas=False`` is the caller's request for the reference's
    unfused formulation (:func:`_unfused`) on either
    device; nothing else chooses it."""
    if data_format != 'NHWC':
        raise ValueError('fused_conv1x1_bn_act requires NHWC')
    if weight.dim() != 4 or tuple(weight.shape[2:]) != (1, 1):
        raise ValueError(f'kernel must be 1x1 OIHW, got '
                         f'{tuple(weight.shape)}')
    if act not in _ACTS:
        raise ValueError(f'act must be None or relu, got {act!r}')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {x.device}')
    if force_pallas is not None and not isinstance(force_pallas, bool):
        raise ValueError(f'force_pallas must be None, True or False, got '
                         f'{force_pallas!r}')
    x = _match_weight_dtype(x, weight)
    scale, shift = scale.to(x.dtype), shift.to(x.dtype)
    if force_pallas is False:
        return _unfused(x, weight, scale, shift, act=act)
    return _FusedConv1x1.apply(x, weight, scale, shift, act)
