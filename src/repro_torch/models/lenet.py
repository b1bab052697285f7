"""LeNet-5 (LeCun et al., 1998) in PyTorch — the paper's experiment model.

conv(6,5x5,SAME) -> tanh -> avgpool -> conv(16,5x5,VALID) -> tanh ->
avgpool -> fc120 -> fc84 -> fc10 on 28x28 single-channel images.
Parameters keep the JAX layouts (HWIO convolutions, [in, out] dense)
and images arrive NHWC; the forward permutes to PyTorch's NCHW/OIHW
for ``F.conv2d`` and flattens in NHWC order, as the JAX model does.

On the CPU both convolutions and every tanh run in float64 and round
once to float32 (:func:`_conv`, :func:`_tanh`), so no float32 CPU
kernel of theirs is on the path.  In some fresh processes the float32
result (and the per-worker gradients) drifted ~50x further from float64
than in the rest; a per-stage report caught the first float32
``torch.tanh`` of a process, on the first convolution's output, 4.25e-5
off float64 where it is 5.7e-8 elsewhere (6 of 192 processes at
ATEN_CPU_CAPABILITY=avx2, none in 240 under this rule; the same call
again in that process was right).  On the card the convolutions and
tanh stay float32 (cuDNN with TF32 off, and torch's CUDA tanh).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.lenet_fmnist import LeNetConfig
from .params import ParamDef


def lenet_defs(cfg: LeNetConfig) -> dict:
    c1, c2 = cfg.conv_channels
    f1, f2 = cfg.fc_dims
    # 28 -> conv5 'SAME' 28 -> pool 14 -> conv5 'VALID' 10 -> pool 5
    flat = c2 * 5 * 5
    return {
        "conv1_w": ParamDef((5, 5, 1, c1), (None, None, None, None)),
        "conv1_b": ParamDef((c1,), (None,), init="zeros"),
        "conv2_w": ParamDef((5, 5, c1, c2), (None, None, None, None)),
        "conv2_b": ParamDef((c2,), (None,), init="zeros"),
        "fc1_w": ParamDef((flat, f1), (None, None)),
        "fc1_b": ParamDef((f1,), (None,), init="zeros"),
        "fc2_w": ParamDef((f1, f2), (None, None)),
        "fc2_b": ParamDef((f2,), (None,), init="zeros"),
        "out_w": ParamDef((f2, cfg.n_classes), (None, None)),
        "out_b": ParamDef((cfg.n_classes,), (None,), init="zeros"),
    }


def _hwio_to_oihw(w):
    return w.permute(3, 2, 0, 1)


def _conv(x, w_hwio, b, padding=0):
    """F.conv2d with the HWIO weight; on the CPU in float64, rounded once
    to x's dtype, so its float32 result (and its gradients') is the
    float64 one rounded, whatever float32 kernel the CPU would pick."""
    w = _hwio_to_oihw(w_hwio)
    if x.is_cuda:
        return F.conv2d(x, w, b, padding=padding)
    wide = torch.float64
    return F.conv2d(x.to(wide), w.to(wide), b.to(wide),
                    padding=padding).to(x.dtype)


def _tanh(x):
    """torch.tanh; on the CPU in float64, rounded once to x's dtype (and
    its gradient likewise), so no float32 CPU tanh is on the path."""
    if x.is_cuda:
        return torch.tanh(x)
    return torch.tanh(x.to(torch.float64)).to(x.dtype)


def lenet_forward(p, images):
    """images [B,28,28,1] (NHWC) -> logits [B,10]."""
    x = images.permute(0, 3, 1, 2)
    x = _conv(x, p["conv1_w"], p["conv1_b"], padding=2)
    x = F.avg_pool2d(_tanh(x), 2)
    x = _conv(x, p["conv2_w"], p["conv2_b"])
    x = F.avg_pool2d(_tanh(x), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)      # NHWC flatten
    x = _tanh(x @ p["fc1_w"] + p["fc1_b"])
    x = _tanh(x @ p["fc2_w"] + p["fc2_b"])
    return x @ p["out_w"] + p["out_b"]


def lenet_loss(p, batch):
    logits = lenet_forward(p, batch["images"])
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, batch["labels"].long()[:, None])
    return -ll.mean()


def lenet_accuracy(p, images, labels):
    pred = torch.argmax(lenet_forward(p, images), dim=-1)
    return (pred == labels.long()).to(torch.float32).mean()
