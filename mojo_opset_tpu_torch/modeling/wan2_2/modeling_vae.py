"""Wan2.2 causal video VAE.

Counterpart of the JAX package's ``modeling/wan2_2/modeling_vae.py``
(``CausalConv3d`` :40, ``Conv2dSame`` :74, ``_upsample2x_nearest`` :99,
``Resample`` :105, ``_stream_conv`` :172, ``ResidualBlock`` :187,
``AttentionBlock`` :208, ``patchify`` / ``unpatchify`` :236 / :248,
``AvgDown3D`` :260, ``DupUp3D`` :282, ``Down_ResidualBlock`` :305,
``Up_ResidualBlock`` :335, ``Encoder3d`` :367, ``Decoder3d`` :402,
``_count_causal_convs`` :437, ``WanVAE_`` :456, ``Wan2_2_VAE`` :517).
Module names follow the JAX package's, so ``state_dict()`` keys equal its
``utils.hf.state_dict_of`` keys.

The temporal feature-cache streaming is part of the model's semantics:
encode consumes frames in 1 + 4k chunks and decode emits one latent frame a
call, each causal conv carrying its last ``CACHE_T`` input frames to the
next chunk (clones, so a chunk's activations are freed). The first decoder
chunk skips the temporal upsample's conv (the ``_REP`` sentinel) and yields
one frame.

Every convolution takes fp32 inputs and fp32 weights, as in JAX, so the
outputs are fp32 whatever came in; the mid attention is single-head over a
frame's h * w positions with its softmax in fp32. These are plain PyTorch
(cuDNN convolutions, ``torch.matmul``): XLA computes them in JAX and no
Pallas kernel lies on this path. Their precision on the card is the
caller's, through PyTorch's flags: by default cuDNN may use TF32 for the fp32
convolutions (``torch.backends.cudnn.allow_tf32``) and matmuls stay full fp32;
``torch.backends.cudnn.flags(enabled=True, allow_tf32=False)`` around a call
computes the convolutions in full fp32 too. ``chip_smoke.py`` phase 16 holds
both against the CPU's fp32 and times both (PERF.md).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mojo_opset_tpu_torch.core.operators import MojoSilu
from mojo_opset_tpu_torch.experimental.operators import MojoChannelRMSNorm
from mojo_opset_tpu_torch.utils.platform import resolve_device

CACHE_T = 2
_REP = object()  # a temporal upsample's cache slot after the first chunk, which skips its conv (JAX's "Rep")


class _Conv(nn.Module):
    """fp32 conv weight (out, in, *kernel) and bias, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as JAX draws them
    (``zero_weight``: the weight starts at 0, the bias as before)."""

    def __init__(self, dim_in, dim_out, kernel, device, zero_weight=False):
        super().__init__()
        device = resolve_device(device)
        self.fan_in = dim_in * math.prod(kernel)
        self.zero_weight = zero_weight
        self.weight = nn.Parameter(torch.empty((dim_out, dim_in, *kernel), device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dim_out, device=device), requires_grad=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / math.sqrt(self.fan_in)
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)
        if self.zero_weight:
            self.weight.zero_()


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


class CausalConv3d(_Conv):
    """3-D conv, causal in time: left-pads 2 * pad_t frames (fewer by the
    frames of ``cache_x`` put in front), symmetric spatial padding."""

    def __init__(self, in_dim, out_dim, kernel_size, stride=1, padding=0, *, device=None):
        self.kernel_size, self.stride, self.pad = _triple(kernel_size), _triple(stride), _triple(padding)
        super().__init__(in_dim, out_dim, self.kernel_size, device)

    def forward(self, x: torch.Tensor, cache_x: Optional[torch.Tensor] = None) -> torch.Tensor:
        pt, ph, pw = self.pad
        t_left = 2 * pt
        if cache_x is not None and t_left > 0:
            x = torch.cat([cache_x.to(x.dtype), x], dim=2)
            t_left -= cache_x.shape[2]
        if t_left:
            x = F.pad(x, (0, 0, 0, 0, t_left, 0))
        if x.shape[2] < self.kernel_size[0]:
            # fewer frames than the kernel: JAX's VALID convolution gives no frames (cuDNN would refuse)
            h, w = ((n + 2 * p - k) // s + 1 for n, p, k, s in zip(x.shape[3:], (ph, pw), self.kernel_size[1:],
                                                                    self.stride[1:]))
            return x.new_zeros((x.shape[0], self.weight.shape[0], 0, h, w), dtype=torch.float32)
        return F.conv3d(x.float(), self.weight, self.bias, stride=self.stride, padding=(0, ph, pw))


class Conv2dSame(_Conv):
    def __init__(self, dim_in, dim_out, kernel, stride=1, padding=0, *, device=None, zero_weight=False):
        kernel = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        self.stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
        self.padding = (padding, padding) if isinstance(padding, int) else tuple(padding)
        super().__init__(dim_in, dim_out, kernel, device, zero_weight)

    def forward(self, x, extra_pad=None):
        """``extra_pad`` (left, right, top, bottom) on top of the symmetric padding."""
        ph, pw = self.padding
        if extra_pad is None:
            return F.conv2d(x.float(), self.weight, self.bias, stride=self.stride, padding=(ph, pw))
        l, r, t, b = extra_pad
        x = F.pad(x.float(), (l + pw, r + pw, t + ph, b + ph))
        return F.conv2d(x, self.weight, self.bias, stride=self.stride)


def _upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W), each value repeated 2 x 2."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class Resample(nn.Module):
    def __init__(self, dim, mode, *, device=None):
        super().__init__()
        assert mode in ("none", "upsample2d", "upsample3d", "downsample2d", "downsample3d")
        self.dim = dim
        self.mode = mode
        if mode in ("upsample2d", "upsample3d"):
            self.conv = Conv2dSame(dim, dim, 3, padding=1, device=device)
        elif mode in ("downsample2d", "downsample3d"):
            self.conv = Conv2dSame(dim, dim, 3, stride=2, padding=0, device=device)
        else:
            self.conv = None
        if mode == "upsample3d":
            self.time_conv = CausalConv3d(dim, dim * 2, (3, 1, 1), padding=(1, 0, 0), device=device)
        elif mode == "downsample3d":
            self.time_conv = CausalConv3d(dim, dim, (3, 1, 1), stride=(2, 1, 1), padding=(0, 0, 0), device=device)
        else:
            self.time_conv = None

    def _spatial(self, x):
        b, c, t, h, w = x.shape
        x2 = x.transpose(1, 2).reshape(b * t, c, h, w)
        if self.mode in ("upsample2d", "upsample3d"):
            x2 = self.conv(_upsample2x_nearest(x2.float()).to(x2.dtype))
        elif self.mode in ("downsample2d", "downsample3d"):
            x2 = self.conv(x2, extra_pad=(0, 1, 0, 1))
        return x2.reshape(b, t, *x2.shape[1:]).transpose(1, 2)

    def forward(self, x, feat_cache=None, feat_idx=None):
        b, c, t, h, w = x.shape
        if self.mode == "upsample3d" and feat_cache is not None:
            idx = feat_idx[0]
            cached = feat_cache[idx]
            if cached is None:
                feat_cache[idx] = _REP
            else:
                cache_x = x[:, :, -CACHE_T:].clone()
                if cache_x.shape[2] < 2:
                    front = torch.zeros_like(cache_x) if cached is _REP else cached[:, :, -1:]
                    cache_x = torch.cat([front, cache_x], dim=2)
                x = self.time_conv(x) if cached is _REP else self.time_conv(x, cached)
                feat_cache[idx] = cache_x
                x = x.reshape(b, 2, c, t, h, w)
                x = torch.stack([x[:, 0], x[:, 1]], dim=3).reshape(b, c, t * 2, h, w)
            feat_idx[0] += 1
        x = self._spatial(x)
        if self.mode == "downsample3d" and feat_cache is not None:
            idx = feat_idx[0]
            if feat_cache[idx] is None:
                feat_cache[idx] = x
            else:
                cache_x = x[:, :, -1:].clone()
                x = self.time_conv(torch.cat([feat_cache[idx][:, :, -1:], x], dim=2))
                feat_cache[idx] = cache_x
            feat_idx[0] += 1
        return x


def _stream_conv(conv, x, feat_cache, feat_idx):
    """Apply a CausalConv3d with CACHE_T frames carried between chunks (the
    reference ResidualBlock's caching pattern)."""
    if feat_cache is None:
        return conv(x)
    idx = feat_idx[0]
    cache_x = x[:, :, -CACHE_T:].clone()
    if cache_x.shape[2] < 2 and feat_cache[idx] is not None:
        cache_x = torch.cat([feat_cache[idx][:, :, -1:], cache_x], dim=2)
    out = conv(x, feat_cache[idx])
    feat_cache[idx] = cache_x
    feat_idx[0] += 1
    return out


class ResidualBlock(nn.Module):
    def __init__(self, in_dim, out_dim, dropout=0.0, *, device=None):
        super().__init__()
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.norm1 = MojoChannelRMSNorm(in_dim, images=False, device=device)
        self.act = MojoSilu()
        self.conv1 = CausalConv3d(in_dim, out_dim, 3, padding=1, device=device)
        self.norm2 = MojoChannelRMSNorm(out_dim, images=False, device=device)
        self.conv2 = CausalConv3d(out_dim, out_dim, 3, padding=1, device=device)
        self.shortcut = CausalConv3d(in_dim, out_dim, 1, device=device) if in_dim != out_dim else None

    def forward(self, x, feat_cache=None, feat_idx=None):
        h = self.shortcut(x) if self.shortcut is not None else x
        y = _stream_conv(self.conv1, self.act(self.norm1(x)), feat_cache, feat_idx)
        y = _stream_conv(self.conv2, self.act(self.norm2(y)), feat_cache, feat_idx)
        return y + h


class AttentionBlock(nn.Module):
    """Per-frame single-head self-attention over h * w positions; the output
    projection's weight starts at zero (JAX :218)."""

    def __init__(self, dim, *, device=None):
        super().__init__()
        self.dim = dim
        self.norm = MojoChannelRMSNorm(dim, device=device)
        self.to_qkv = Conv2dSame(dim, dim * 3, 1, device=device)
        self.proj = Conv2dSame(dim, dim, 1, device=device, zero_weight=True)

    def forward(self, x):
        identity = x
        b, c, t, h, w = x.shape
        x2 = self.norm(x.transpose(1, 2).reshape(b * t, c, h, w))
        qkv = self.to_qkv(x2).reshape(b * t, 3 * c, h * w).transpose(1, 2)  # (bt, hw, 3c)
        q, k, v = qkv.chunk(3, dim=-1)
        scores = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(c)
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b * t, c, h, w)
        out = self.proj(out)
        return out.reshape(b, t, c, h, w).transpose(1, 2) + identity


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``b c (h q) (w r) -> b (c r q) h w`` (and with a frame axis after c)."""
    if patch_size == 1:
        return x
    p = patch_size
    if x.ndim == 4:
        b, c, h, w = x.shape
        return x.reshape(b, c, h // p, p, w // p, p).permute(0, 1, 5, 3, 2, 4).reshape(b, c * p * p, h // p, w // p)
    if x.ndim == 5:
        b, c, f, h, w = x.shape
        x = x.reshape(b, c, f, h // p, p, w // p, p).permute(0, 1, 6, 4, 2, 3, 5)
        return x.reshape(b, c * p * p, f, h // p, w // p)
    raise ValueError(f"Invalid input shape: {tuple(x.shape)}")


def unpatchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``b (c r q) h w -> b c (h q) (w r)`` (and with a frame axis after c)."""
    if patch_size == 1:
        return x
    p = patch_size
    if x.ndim == 4:
        b, crq, h, w = x.shape
        x = x.reshape(b, crq // (p * p), p, p, h, w).permute(0, 1, 4, 3, 5, 2)
        return x.reshape(b, crq // (p * p), h * p, w * p)
    if x.ndim == 5:
        b, crq, f, h, w = x.shape
        x = x.reshape(b, crq // (p * p), p, p, f, h, w).permute(0, 1, 4, 5, 3, 6, 2)
        return x.reshape(b, crq // (p * p), f, h * p, w * p)
    return x


class AvgDown3D(nn.Module):
    """Space- and time-to-channel, then the mean of each group of channels;
    the frames are padded in front to a multiple of ``factor_t``."""

    def __init__(self, in_channels, out_channels, factor_t, factor_s=1):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.factor_t = factor_t
        self.factor_s = factor_s
        self.factor = factor_t * factor_s * factor_s
        assert in_channels * self.factor % out_channels == 0
        self.group_size = in_channels * self.factor // out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad_t = (self.factor_t - x.shape[2] % self.factor_t) % self.factor_t
        x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
        B, C, T, H, W = x.shape
        ft, fs = self.factor_t, self.factor_s
        x = x.reshape(B, C, T // ft, ft, H // fs, fs, W // fs, fs).permute(0, 1, 3, 5, 7, 2, 4, 6)
        x = x.reshape(B, self.out_channels, self.group_size, T // ft, H // fs, W // fs)
        return x.mean(dim=2)


class DupUp3D(nn.Module):
    """Channel-to-space and -time by repetition; a first chunk drops its
    first ``factor_t - 1`` frames."""

    def __init__(self, in_channels, out_channels, factor_t, factor_s=1):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.factor_t = factor_t
        self.factor_s = factor_s
        self.factor = factor_t * factor_s * factor_s
        assert out_channels * self.factor % in_channels == 0
        self.repeats = out_channels * self.factor // in_channels

    def forward(self, x: torch.Tensor, first_chunk: bool = False) -> torch.Tensor:
        x = x.repeat_interleave(self.repeats, dim=1)
        B, _, T, H, W = x.shape
        ft, fs = self.factor_t, self.factor_s
        x = x.reshape(B, self.out_channels, ft, fs, fs, T, H, W).permute(0, 1, 5, 2, 6, 3, 7, 4)
        x = x.reshape(B, self.out_channels, T * ft, H * fs, W * fs)
        return x[:, :, ft - 1:] if first_chunk else x


class Down_ResidualBlock(nn.Module):
    def __init__(self, in_dim, out_dim, dropout, mult, temperal_downsample=False, down_flag=False, *, device=None):
        super().__init__()
        self.avg_shortcut = AvgDown3D(in_dim, out_dim, factor_t=2 if temperal_downsample else 1,
                                      factor_s=2 if down_flag else 1)
        self.blocks = nn.ModuleList(ResidualBlock(in_dim if i == 0 else out_dim, out_dim, dropout, device=device)
                                    for i in range(mult))
        self.resample = (Resample(out_dim, mode="downsample3d" if temperal_downsample else "downsample2d",
                                  device=device) if down_flag else None)

    def forward(self, x, feat_cache=None, feat_idx=None):
        x_copy = x
        for block in self.blocks:
            x = block(x, feat_cache, feat_idx)
        if self.resample is not None:
            x = self.resample(x, feat_cache, feat_idx)
        return x + self.avg_shortcut(x_copy)


class Up_ResidualBlock(nn.Module):
    def __init__(self, in_dim, out_dim, dropout, mult, temperal_upsample=False, up_flag=False, *, device=None):
        super().__init__()
        self.avg_shortcut = (DupUp3D(in_dim, out_dim, factor_t=2 if temperal_upsample else 1,
                                     factor_s=2 if up_flag else 1) if up_flag else None)
        self.blocks = nn.ModuleList(ResidualBlock(in_dim if i == 0 else out_dim, out_dim, dropout, device=device)
                                    for i in range(mult))
        self.resample = (Resample(out_dim, mode="upsample3d" if temperal_upsample else "upsample2d", device=device)
                         if up_flag else None)

    def forward(self, x, feat_cache=None, feat_idx=None, first_chunk=False):
        x_main = x
        for block in self.blocks:
            x_main = block(x_main, feat_cache, feat_idx)
        if self.resample is not None:
            x_main = self.resample(x_main, feat_cache, feat_idx)
        if self.avg_shortcut is not None:
            return x_main + self.avg_shortcut(x, first_chunk)
        return x_main


class Encoder3d(nn.Module):
    def __init__(self, dim=128, z_dim=4, dim_mult=(1, 2, 4, 4), num_res_blocks=2, attn_scales=(),
                 temperal_downsample=(True, True, False), dropout=0.0, *, device=None):
        super().__init__()
        dims = [dim * u for u in [1] + list(dim_mult)]
        self.conv1 = CausalConv3d(12, dims[0], 3, padding=1, device=device)
        self.downsamples = nn.ModuleList(
            Down_ResidualBlock(in_dim, out_dim, dropout, num_res_blocks,
                               temperal_downsample=temperal_downsample[i] if i < len(temperal_downsample) else False,
                               down_flag=i != len(dim_mult) - 1, device=device)
            for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])))
        out_dim = dims[-1]
        self.mid_block1 = ResidualBlock(out_dim, out_dim, dropout, device=device)
        self.mid_attn = AttentionBlock(out_dim, device=device)
        self.mid_block2 = ResidualBlock(out_dim, out_dim, dropout, device=device)
        self.head_norm = MojoChannelRMSNorm(out_dim, images=False, device=device)
        self.head_act = MojoSilu()
        self.head_conv = CausalConv3d(out_dim, z_dim, 3, padding=1, device=device)

    def forward(self, x, feat_cache=None, feat_idx=None):
        x = _stream_conv(self.conv1, x, feat_cache, feat_idx)
        for layer in self.downsamples:
            x = layer(x, feat_cache, feat_idx)
        x = self.mid_block1(x, feat_cache, feat_idx)
        x = self.mid_attn(x)
        x = self.mid_block2(x, feat_cache, feat_idx)
        x = self.head_act(self.head_norm(x))
        return _stream_conv(self.head_conv, x, feat_cache, feat_idx)


class Decoder3d(nn.Module):
    def __init__(self, dim=128, z_dim=4, dim_mult=(1, 2, 4, 4), num_res_blocks=2, attn_scales=(),
                 temperal_upsample=(False, True, True), dropout=0.0, *, device=None):
        super().__init__()
        dims = [dim * u for u in [dim_mult[-1]] + list(dim_mult)[::-1]]
        self.conv1 = CausalConv3d(z_dim, dims[0], 3, padding=1, device=device)
        self.mid_block1 = ResidualBlock(dims[0], dims[0], dropout, device=device)
        self.mid_attn = AttentionBlock(dims[0], device=device)
        self.mid_block2 = ResidualBlock(dims[0], dims[0], dropout, device=device)
        self.upsamples = nn.ModuleList(
            Up_ResidualBlock(in_dim, out_dim, dropout, num_res_blocks + 1,
                             temperal_upsample=temperal_upsample[i] if i < len(temperal_upsample) else False,
                             up_flag=i != len(dim_mult) - 1, device=device)
            for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])))
        out_dim = dims[-1]
        self.head_norm = MojoChannelRMSNorm(out_dim, images=False, device=device)
        self.head_act = MojoSilu()
        self.head_conv = CausalConv3d(out_dim, 12, 3, padding=1, device=device)

    def forward(self, x, feat_cache=None, feat_idx=None, first_chunk=False):
        x = _stream_conv(self.conv1, x, feat_cache, feat_idx)
        x = self.mid_block1(x, feat_cache, feat_idx)
        x = self.mid_attn(x)
        x = self.mid_block2(x, feat_cache, feat_idx)
        for layer in self.upsamples:
            x = layer(x, feat_cache, feat_idx, first_chunk)
        x = self.head_act(self.head_norm(x))
        return _stream_conv(self.head_conv, x, feat_cache, feat_idx)


def _count_causal_convs(mod: nn.Module) -> int:
    return sum(isinstance(m, CausalConv3d) for m in mod.modules())


def _per_channel(v, z_dim: int):
    """A (z_dim,) scale tensor shaped to broadcast over (B, z_dim, T, H, W); a scalar as it is."""
    return v.reshape(1, z_dim, 1, 1, 1) if isinstance(v, torch.Tensor) and v.ndim > 0 else v


class WanVAE_(nn.Module):
    """The causal video VAE: ``encode(x (B, 3, T, H, W), scale)`` -> the
    latent mean (B, z_dim, T', H / 16, W / 16), ``decode(z, scale)`` -> the
    video; ``scale`` is ``(mean, 1 / std)`` of the latents, scalars or
    (z_dim,) tensors. JAX's defaults, ``temperal_downsample=(True, True,
    False)`` among them. Built on the card unless ``device`` names another;
    ``generator`` draws every conv with JAX's distributions (the attention's
    output projection weight stays 0, the norms 1)."""

    def __init__(self, dim=160, dec_dim=256, z_dim=16, dim_mult=(1, 2, 4, 4), num_res_blocks=2, attn_scales=(),
                 temperal_downsample=(True, True, False), dropout=0.0, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.z_dim = z_dim
        self.encoder = Encoder3d(dim, z_dim * 2, dim_mult, num_res_blocks, attn_scales, temperal_downsample, dropout,
                                 device=device)
        self.conv1 = CausalConv3d(z_dim * 2, z_dim * 2, 1, device=device)
        self.conv2 = CausalConv3d(z_dim, z_dim, 1, device=device)
        self.decoder = Decoder3d(dec_dim, z_dim, dim_mult, num_res_blocks, attn_scales,
                                 tuple(temperal_downsample)[::-1], dropout, device=device)
        if generator is not None:
            from mojo_opset_tpu_torch.utils.weights import init_random_

            init_random_(self, generator)

    def encode(self, x: torch.Tensor, scale=(0.0, 1.0)) -> torch.Tensor:
        """Frames consumed in 1 + 4k chunks with streamed conv caches."""
        x = patchify(x, patch_size=2)
        n_chunks = 1 + (x.shape[2] - 1) // 4
        feat_map = [None] * _count_causal_convs(self.encoder)
        outs = []
        for i in range(n_chunks):
            chunk = x[:, :, :1] if i == 0 else x[:, :, 1 + 4 * (i - 1):1 + 4 * i]
            outs.append(self.encoder(chunk, feat_cache=feat_map, feat_idx=[0]))
        mu, _log_var = self.conv1(torch.cat(outs, dim=2)).chunk(2, dim=1)
        s0, s1 = scale
        return (mu - _per_channel(s0, self.z_dim)) * _per_channel(s1, self.z_dim)

    def decode(self, z: torch.Tensor, scale=(0.0, 1.0)) -> torch.Tensor:
        """One latent frame a decoder call, the conv caches streamed."""
        s0, s1 = scale
        z = z / _per_channel(s1, self.z_dim) + _per_channel(s0, self.z_dim)
        x = self.conv2(z)
        feat_map = [None] * _count_causal_convs(self.decoder)
        outs = [self.decoder(x[:, :, i:i + 1], feat_cache=feat_map, feat_idx=[0], first_chunk=i == 0)
                for i in range(z.shape[2])]
        return unpatchify(torch.cat(outs, dim=2), patch_size=2)

    def forward(self, x, scale=(0.0, 1.0)):
        mu = self.encode(x, scale)
        return self.decode(mu, scale), mu

    def reparameterize(self, mu, log_var, generator: Optional[torch.Generator] = None):
        std = torch.exp(0.5 * log_var)
        return mu + std * torch.randn(std.shape, dtype=std.dtype, device=std.device, generator=generator)


class Wan2_2_VAE:
    """Inference wrapper with the latents' mean / std scaling: ``encode``
    and ``decode`` take lists of (C, T, H, W) tensors; decoded videos are
    clipped to [-1, 1]. Without ``vae`` it builds ``WanVAE_(dim, dec_dim,
    z_dim, temperal_downsample=(True, True, True))`` as JAX does; ``mean``
    and ``std`` default to zeros and ones."""

    def __init__(self, vae: Optional[WanVAE_] = None, z_dim: int = 48, dim: int = 160, dec_dim: int = 256, mean=None,
                 std=None, dtype=torch.float32, *, device=None, generator: Optional[torch.Generator] = None):
        self.dtype = dtype
        self.model = vae or WanVAE_(dim=dim, dec_dim=dec_dim, z_dim=z_dim, temperal_downsample=(True, True, True),
                                    device=device, generator=generator)
        device = self.model.conv1.weight.device
        self.mean = (torch.zeros(z_dim, device=device) if mean is None
                     else torch.as_tensor(mean, dtype=torch.float32).to(device))
        self.std = (torch.ones(z_dim, device=device) if std is None
                    else torch.as_tensor(std, dtype=torch.float32).to(device))
        self.scale = (self.mean, 1.0 / self.std)

    def encode(self, videos: List[torch.Tensor]) -> List[torch.Tensor]:
        return [self.model.encode(u[None].to(self.dtype), self.scale)[0] for u in videos]

    def decode(self, zs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [self.model.decode(u[None].to(self.dtype), self.scale)[0].clamp(-1, 1) for u in zs]
