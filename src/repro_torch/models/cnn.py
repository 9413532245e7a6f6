"""The paper's own evaluation models, LeNet (MNIST) and the 4-layer ConvNet
(CIFAR-10), in PyTorch (the port of ``repro/models/cnn.py``).

Parameters keep the JAX layouts, so one artifact ``.npz`` serves both
packages: conv ``w`` is HWIO ``(kh, kw, cin, cout)`` and fc ``w`` is
``(in, out)``.  :func:`cnn_forward` takes NHWC images and runs the
convolutions (``padding="same"``, stride 1) and 2x2 max pools in NCHW
internally, then flattens in NHWC order, as the JAX package's
``x.reshape(B, -1)`` on ``(B, H, W, C)`` does, so the first fc's weights
line up.  The JAX package runs its convolutions in XLA, outside any Pallas
kernel; the port leaves them to the library as well.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.energy import LayerShape
from repro_torch.models.base import ParamDesc


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    kh: int
    kw: int
    cin: int
    cout: int
    pool: bool  # 2x2 max pool after


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: tuple
    input_c: int
    convs: tuple
    fc: tuple  # hidden fc widths
    n_classes: int

    @property
    def conv_layers(self):
        return self.convs


LENET = CNNConfig(
    name="lenet",
    input_hw=(28, 28),
    input_c=1,
    convs=(ConvSpec(5, 5, 1, 6, True), ConvSpec(5, 5, 6, 16, True)),
    fc=(120, 84),
    n_classes=10,
)

CONVNET4 = CNNConfig(
    name="convnet4",
    input_hw=(32, 32),
    input_c=3,
    convs=(
        ConvSpec(3, 3, 3, 32, False),
        ConvSpec(3, 3, 32, 32, True),
        ConvSpec(3, 3, 32, 64, False),
        ConvSpec(3, 3, 64, 64, True),
    ),
    fc=(512,),
    n_classes=10,
)


def _flat_dim(cfg: CNNConfig) -> int:
    h, w = cfg.input_hw
    c = cfg.input_c
    for cs in cfg.convs:
        # 'same' conv keeps H, W; pooling halves
        c = cs.cout
        if cs.pool:
            h, w = h // 2, w // 2
    return h * w * c


def cnn_descs(cfg: CNNConfig) -> dict:
    descs = {"convs": [], "fcs": []}
    for cs in cfg.convs:
        descs["convs"].append({
            "w": ParamDesc((cs.kh, cs.kw, cs.cin, cs.cout), (None, None, None, None)),
            "b": ParamDesc((cs.cout,), (None,), init="zeros"),
        })
    dims = [_flat_dim(cfg), *cfg.fc, cfg.n_classes]
    for i in range(len(dims) - 1):
        descs["fcs"].append({
            "w": ParamDesc((dims[i], dims[i + 1]), (None, None)),
            "b": ParamDesc((dims[i + 1],), (None,), init="zeros"),
        })
    return descs


def cnn_forward(params: dict, cfg: CNNConfig, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) f32 -> logits (B, n_classes)."""
    x = images.to(torch.float32).permute(0, 3, 1, 2)
    for cs, p in zip(cfg.convs, params["convs"], strict=True):
        x = F.conv2d(x, p["w"].permute(3, 2, 0, 1), padding="same") + p["b"][:, None, None]
        x = F.relu(x)
        if cs.pool:
            x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    for i, p in enumerate(params["fcs"]):
        x = x @ p["w"] + p["b"]
        if i < len(params["fcs"]) - 1:
            x = F.relu(x)
    return x


def cnn_loss(params: dict, cfg: CNNConfig, batch: dict) -> torch.Tensor:
    logits = cnn_forward(params, cfg, batch["images"])
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, batch["labels"].to(torch.int64)[:, None]))


def cnn_accuracy(params: dict, cfg: CNNConfig, images, labels) -> float:
    """Top-1 accuracy; numpy ``images``/``labels`` go to the params' device."""
    dev = params["fcs"][0]["w"].device
    logits = cnn_forward(params, cfg, torch.as_tensor(images, device=dev))
    hit = torch.argmax(logits, -1) == torch.as_tensor(labels, device=dev)
    return float(torch.mean(hit.to(torch.float32)))


def conv_layer_shapes(cfg: CNNConfig) -> list[LayerShape]:
    """(name, H, W, C, Num) per conv layer for the Eq. 11/12 model."""
    return [LayerShape(f"conv{i}", cs.kh, cs.kw, cs.cin, cs.cout)
            for i, cs in enumerate(cfg.convs)]
