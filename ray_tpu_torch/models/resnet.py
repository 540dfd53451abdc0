"""ResNet (18/50) in PyTorch: the image-training benchmark model.

Port of ``ray_tpu/models/resnet.py`` with the same numerics:
- the parameter tree keeps the JAX keys and HWIO conv shapes, with
  ``stages`` a list of lists of block dicts, so ``params_from_numpy``
  carries JAX weights across unchanged and an optimizer sees the same
  leaves;
- ``apply`` takes ``[B, H, W, 3]`` images, as the JAX function does;
  ``permute(0, 3, 1, 2)`` makes that an NCHW view in ``channels_last``
  memory, and activations stay ``channels_last`` through the network, so
  cuDNN runs its NHWC kernels with no layout copy around a conv;
- each weight is cast to ``cfg.dtype`` at every use (the JAX code does the
  same), and the cast is also the one HWIO -> OIHW ``channels_last`` copy;
- XLA's ``SAME`` padding is uneven for a stride-2 window on an even side
  (``total // 2`` low, the rest high); torch's ``padding=`` is symmetric,
  so an uneven pad is an explicit ``F.pad`` before the conv or pool;
- batch norm uses batch statistics only (no running stats), in f32 with
  the biased variance and eps 1e-5; the global mean and the head run in
  f32.

The convolutions are ``F.conv2d`` (cuDNN on the card), as the JAX package
leaves them to XLA: ResNet has no Pallas kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import DeviceLike, resolve_device

Params = Dict[str, Any]


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)   # resnet18
    num_classes: int = 1000
    width: int = 64
    bottleneck: bool = False
    dtype: torch.dtype = torch.bfloat16


def resnet18(num_classes: int = 1000) -> ResNetConfig:
    return ResNetConfig((2, 2, 2, 2), num_classes, bottleneck=False)


def resnet50(num_classes: int = 1000) -> ResNetConfig:
    return ResNetConfig((3, 4, 6, 3), num_classes, bottleneck=True)


def _tree_map(fn, tree):
    """Map over the leaves of nested dicts and lists (a tuple is a leaf:
    ``param_shapes`` has shapes there)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _blocks(cfg: ResNetConfig):
    """(stage, block, stride, cin, cmid, cout) of every block, in order."""
    cin = cfg.width
    expansion = 4 if cfg.bottleneck else 1
    for si, n_blocks in enumerate(cfg.stage_sizes):
        cmid = cfg.width * (2 ** si)
        cout = cmid * expansion
        for bi in range(n_blocks):
            yield si, bi, (2 if (si > 0 and bi == 0) else 1), cin, cmid, cout
            cin = cout


def param_shapes(cfg: ResNetConfig) -> Params:
    """The parameter tree's shapes: convs HWIO, batch norms ``(C,)``."""
    def bn(c):
        return {"scale": (c,), "bias": (c,)}

    shapes: Params = {"stem": {"conv": (7, 7, 3, cfg.width),
                               "bn": bn(cfg.width)},
                      "stages": [[] for _ in cfg.stage_sizes]}
    cout = cfg.width
    for si, _, stride, cin, cmid, cout in _blocks(cfg):
        if cfg.bottleneck:
            blk = {"conv1": (1, 1, cin, cmid), "bn1": bn(cmid),
                   "conv2": (3, 3, cmid, cmid), "bn2": bn(cmid),
                   "conv3": (1, 1, cmid, cout), "bn3": bn(cout)}
        else:
            blk = {"conv1": (3, 3, cin, cmid), "bn1": bn(cmid),
                   "conv2": (3, 3, cmid, cout), "bn2": bn(cout)}
        if stride != 1 or cin != cout:
            blk["proj"] = (1, 1, cin, cout)
            blk["proj_bn"] = bn(cout)
        shapes["stages"][si].append(blk)
    shapes["head"] = {"w": (cout, cfg.num_classes), "b": (cfg.num_classes,)}
    return shapes


def init_params(cfg: ResNetConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Initialize the parameter tree (float32) on ``device``.

    Same shapes and scales as the JAX ``init_params`` (He-normal convs,
    unit scale and zero bias in batch norm, a 0.01-normal head); the values
    are drawn from ``generator`` on its own device and differ from JAX's.
    """
    device = resolve_device(device)

    def init(tree, key=None):
        """``key`` is the dict key a leaf sits under: it names its kind."""
        if isinstance(tree, dict):
            return {k: init(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [init(v) for v in tree]
        if key == "scale":
            return torch.ones(tree, device=device)
        if key in ("bias", "b"):
            return torch.zeros(tree, device=device)
        x = torch.randn(tree, generator=generator, dtype=torch.float32,
                        device=generator.device)
        std = 0.01 if key == "w" else math.sqrt(2.0 / math.prod(tree[:3]))
        return (x * std).to(device)

    return init(param_shapes(cfg))


def params_from_numpy(tree: Params, cfg: ResNetConfig,
                      device: DeviceLike = None) -> Params:
    """Carry a JAX parameter tree across: ``tree`` is the JAX params as numpy
    (``jax.tree.map(np.asarray, params)``); returns float32 tensors on
    ``device``. Shapes are checked against ``cfg``."""
    device = resolve_device(device)
    got = _tree_map(lambda x: tuple(np.shape(x)), tree)
    if got != param_shapes(cfg):
        raise ValueError(f"parameter tree does not match {cfg}: got {got}, "
                         f"expected {param_shapes(cfg)}")
    return _tree_map(lambda x: torch.tensor(
        np.asarray(x, dtype=np.float32), device=device), tree)


def same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's ``SAME`` for one spatial side: the
    output has ``ceil(size / s)`` positions, and the total pad is split
    ``total // 2`` low and the rest high."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, k: int, s: int):
    """``SAME`` pads of an NCHW tensor's two sides: ``(symmetric, pads)``,
    with ``pads`` as torch's ``padding=`` when symmetric, else as
    ``F.pad``'s ``(w_lo, w_hi, h_lo, h_hi)``."""
    (hl, hh), (wl, wh) = (same_padding(n, k, s) for n in x.shape[2:])
    if hl == hh and wl == wh:
        return True, (hl, wl)
    return False, (wl, wh, hl, hh)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``conv_general_dilated(x, w, stride, "SAME")``: ``x`` NCHW (kept in
    its memory format), ``w`` HWIO; input and weight cast to ``dtype``, and
    the output stays in it."""
    x = x.to(dtype)
    w = w.permute(3, 2, 0, 1).to(dtype, memory_format=torch.channels_last)
    symmetric, pads = _pads(x, w.shape[2], stride)
    if symmetric:
        return F.conv2d(x, w, stride=stride, padding=pads)
    return F.conv2d(F.pad(x, pads), w, stride=stride)


def max_pool(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """``reduce_window(x, -inf, max, k, s, "SAME")`` on an NCHW tensor."""
    symmetric, pads = _pads(x, k, s)
    if symmetric:  # max_pool2d's own padding is -inf
        return F.max_pool2d(x, k, s, padding=pads)
    return F.max_pool2d(F.pad(x, pads, value=-math.inf), k, s)


def _bn(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Per-batch normalization statistics (training mode), in f32.

    ``(x - mean) * rsqrt(var + eps) * scale + bias`` is computed as
    ``x * a + b`` with per-channel ``a`` and ``b``: the same function,
    with one elementwise pass over the activation instead of four."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0, keepdim=True)
    a = p["scale"].view(1, -1, 1, 1) * torch.rsqrt(var + 1e-5)
    b = p["bias"].view(1, -1, 1, 1) - mean * a
    return torch.addcmul(b, xf, a).to(x.dtype)


def _basic_block(x, blk, stride, dtype):
    y = F.relu(_bn(conv(x, blk["conv1"], stride, dtype), blk["bn1"]))
    y = _bn(conv(y, blk["conv2"], 1, dtype), blk["bn2"])
    sc = x
    if "proj" in blk:
        sc = _bn(conv(x, blk["proj"], stride, dtype), blk["proj_bn"])
    return F.relu(y + sc)


def _bottleneck_block(x, blk, stride, dtype):
    y = F.relu(_bn(conv(x, blk["conv1"], 1, dtype), blk["bn1"]))
    y = F.relu(_bn(conv(y, blk["conv2"], stride, dtype), blk["bn2"]))
    y = _bn(conv(y, blk["conv3"], 1, dtype), blk["bn3"])
    sc = x
    if "proj" in blk:
        sc = _bn(conv(x, blk["proj"], stride, dtype), blk["proj_bn"])
    return F.relu(y + sc)


def apply(params: Params, images: torch.Tensor,
          cfg: ResNetConfig) -> torch.Tensor:
    """images: [B, H, W, 3] -> logits [B, num_classes] (float32)."""
    dtype = cfg.dtype
    x = images.permute(0, 3, 1, 2)      # NCHW view, channels_last memory
    x = x.contiguous(memory_format=torch.channels_last)  # no-op if so
    x = conv(x, params["stem"]["conv"], 2, dtype)
    x = max_pool(F.relu(_bn(x, params["stem"]["bn"])))
    block = _bottleneck_block if cfg.bottleneck else _basic_block
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if (si > 0 and bi == 0) else 1
            x = block(x, blk, stride, dtype)
    x = x.float().mean(dim=(2, 3))
    return x @ params["head"]["w"] + params["head"]["b"]


def loss_fn(params: Params, images: torch.Tensor, labels: torch.Tensor,
            cfg: ResNetConfig) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``log_softmax``."""
    logp = torch.log_softmax(apply(params, images, cfg), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def leaves(params: Params) -> List[torch.Tensor]:
    """The parameter tree's tensors, in a fixed order."""
    return list(_leaves(params))


def num_params(params: Params) -> int:
    return sum(int(p.numel()) for p in _leaves(params))
