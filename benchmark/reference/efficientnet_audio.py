"""The plain reference of the benchmark's BirdNET v2.4- and Perch v2-shaped
models: their forward pass in plain PyTorch at float32, written from the
architecture the frozen generators (:mod:`benchmark.models`) describe and
the same configuration file, with no kernel, cache, fusion or batching of
the program. It imports nothing of the program and takes nothing the
program made: it scales the raw int16 samples itself, frames them with the
frontend's strided convolution, and applies each batch normalization from
its four raw statistics (the program folds them into the convolutions).

The caller turns TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so every product is float32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
LOG_EPS = 1e-6
_CALIBRATING = False


def _bn(x, w, name):
    if _CALIBRATING:
        w[f"{name}.m"] = x.mean(dim=(0, 2, 3))
        w[f"{name}.v"] = x.var(dim=(0, 2, 3), unbiased=False)
    return F.batch_norm(x, w[f"{name}.m"], w[f"{name}.v"], w[f"{name}.s"], w[f"{name}.b"],
                        training=False, eps=BN_EPS)


def _conv_bn_swish(x, w, name, stride=1, groups=1):
    k = w[f"{name}.conv.w"]
    y = F.conv2d(x, k, stride=stride, padding=k.shape[-1] // 2, groups=groups)
    return F.silu(_bn(y, w, f"{name}.bn"))


def _mbconv(x, w, name, c_in, c_out, stride):
    y = _conv_bn_swish(x, w, f"{name}.expand")
    y = _conv_bn_swish(y, w, f"{name}.dw", stride=stride, groups=y.shape[1])
    s = y.mean(dim=(2, 3), keepdim=True)
    s = F.silu(F.conv2d(s, w[f"{name}.se.reduce.w"], w[f"{name}.se.reduce.b"]))
    s = torch.sigmoid(F.conv2d(s, w[f"{name}.se.expand.w"], w[f"{name}.se.expand.b"]))
    y = _bn(F.conv2d(y * s, w[f"{name}.project.conv.w"]), w, f"{name}.project.bn")
    return x + y if stride == 1 and c_in == c_out else y


def blocks(cfg: dict):
    """``(name, c_in, c_out, stride)`` of every MBConv block in order: each
    stage (``[c_out, expand, kernel, stride]``) repeated ``repeats`` times,
    its first block strided. The expand ratio, the kernel and the
    squeeze-excite width are read from the weights' shapes."""
    out = []
    c_in = cfg["stem_channels"]
    for (c_out, _, _, stride), repeats in zip(cfg["stages"], cfg["repeats"]):
        for r in range(repeats):
            out.append((f"b{len(out)}", c_in, c_out, stride if r == 0 else 1))
            c_in = c_out
    return out


def forward(cfg: dict, w: Dict[str, torch.Tensor], pcm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``pcm``: int16 segments ``[N, sample_count]``. Returns the logits
    ``[N, num_species]`` and, for a model with embeddings, the pooled
    embedding ``[N, E]``, in float32."""
    x = pcm.to(torch.float32) * (1.0 / 32768.0)
    fb = F.conv1d(x[:, None, :], w["frontend.w"], stride=cfg["hop"])
    x = torch.log(fb * fb + LOG_EPS)[:, None]
    x = _conv_bn_swish(x, w, "stem", stride=2)
    for name, c_in, c_out, stride in blocks(cfg):
        x = _mbconv(x, w, name, c_in, c_out, stride)
    x = _conv_bn_swish(x, w, "head")
    if cfg.get("embedding_dim"):
        emb = x.mean(dim=2).mean(dim=2)  # over frequency, then time
        return {"embedding": emb, "logits": F.linear(emb, w["logits.w"], w["logits.b"])}
    return {"logits": F.linear(x.mean(dim=(2, 3)), w["output.w"], w["output.b"])}


def calibrate(cfg: dict, w: Dict[str, torch.Tensor], pcm: torch.Tensor) -> None:
    """Set every batch norm's running mean and variance, in place in ``w``,
    to its input's per-channel statistics over ``pcm`` (int16 segments),
    layer after layer in one forward pass: the statistics a trained model
    carries, so that each batch norm brings its input to the scale and
    shift it draws. Without this the random model's activations grow
    through depth until rounding in the last bits moves its answers."""
    global _CALIBRATING
    _CALIBRATING = True
    try:
        forward(cfg, w, pcm)
    finally:
        _CALIBRATING = False
