"""Training loops of the paper's CNNs (the port of the repo's CNN trainer,
``benchmarks/common.py::train_cnn`` / ``finetune_fc``).

Both run the port's AdamW (no weight decay) on the synthetic class-template
images: :func:`train_cnn` trains from a seeded init, :func:`finetune_fc`
retrains only the fully connected layers of given params (the conv
gradients are zeroed, so AdamW leaves the convs where they are: Table III
rows 3/4).
"""
from __future__ import annotations

import torch

from repro_torch.data.pipeline import image_batches, synthetic_image_dataset
from repro_torch.models.base import init_params, resolve_device
from repro_torch.models.cnn import CNNConfig, cnn_descs, cnn_loss
from repro_torch.optim import AdamWConfig, adamw_init_descs, adamw_update
from repro_torch.tree import tree_map


def cnn_train_step(ocfg: AdamWConfig, cfg: CNNConfig, params, opt, batch,
                   fc_only: bool = False):
    """One AdamW step on ``cnn_loss`` -> (params, opt, loss); with
    ``fc_only`` the conv gradients are zeros."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = cnn_loss(params, cfg, batch)
        loss.backward()
    grads = tree_map(lambda p: p.grad, params)
    if fc_only:
        grads = {"convs": tree_map(torch.zeros_like, grads["convs"]), "fcs": grads["fcs"]}
    with torch.no_grad():
        params, opt, _ = adamw_update(ocfg, params, grads, opt)
    return params, opt, loss.detach()


def train_cnn(cfg: CNNConfig, steps: int = 150, lr: float = 2e-3, n: int = 768,
              seed: int = 0, batch: int = 64, noise: float = 0.30, device="cuda"):
    """Train a CNN on the synthetic class-template dataset on ``device``.
    Returns (params, train_images, train_labels, eval_images, eval_labels),
    the images and labels as numpy arrays."""
    dev = resolve_device(device)
    imgs, labels = synthetic_image_dataset(n, cfg.input_hw, cfg.input_c, cfg.n_classes,
                                           seed=seed, noise=noise)
    n_eval = max(n // 4, 64)
    tr_i, tr_l = imgs[:-n_eval], labels[:-n_eval]
    ev_i, ev_l = imgs[-n_eval:], labels[-n_eval:]
    descs = cnn_descs(cfg)
    params = init_params(descs, torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt = init_params(adamw_init_descs(descs), device=dev)
    ocfg = AdamWConfig(lr=lr, weight_decay=0.0)
    it = image_batches(tr_i, tr_l, batch, seed=seed + 1, device=dev)
    for _ in range(steps):
        _, b = next(it)
        params, opt, _ = cnn_train_step(ocfg, cfg, params, opt, b)
    return params, tr_i, tr_l, ev_i, ev_l


def finetune_fc(params, cfg: CNNConfig, imgs, labels, steps: int = 60, lr: float = 1e-3,
                seed: int = 3):
    """FC-only fine-tune (convs frozen) on the params' device: Table III
    rows 3/4."""
    dev = params["fcs"][0]["w"].device
    ocfg = AdamWConfig(lr=lr, weight_decay=0.0)
    opt = init_params(adamw_init_descs(cnn_descs(cfg)), device=dev)
    it = image_batches(imgs, labels, 64, seed=seed, device=dev)
    for _ in range(steps):
        _, b = next(it)
        params, opt, _ = cnn_train_step(ocfg, cfg, params, opt, b, fc_only=True)
    return params
