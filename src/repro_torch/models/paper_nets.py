"""The paper's evaluation set (§VI): VGG-16, ResNet-50, DenseNet-161,
BERT-Base and BERT-Large as ARAS layer graphs — the port's copy of
`repro.models.paper_nets`.

Only weight-bearing layers occupy crossbars (CONV/FC, Fig 3); pooling,
normalization and non-linearities run on the SFU and are folded into the
producing layer's output.  BERT's activation×activation attention matmuls
(QKᵀ, AV) have no stationary weights and therefore cannot map to ReRAM
crossbars; like prior PUM work the graphs contain the six weight projections
per encoder layer (the paper reports BERT sees no replication speedup —
consistent with an FC-only mapping).

Weights: pretrained checkpoints are not available offline, so INT8 code
distributions are synthesized per layer — a bell-shaped body with a small
outlier tail (which stretches the quantization range and concentrates codes,
as in real post-training-quantized DNNs) and per-layer mean jitter matching
the spread of the paper's Fig 11.  All generators are seeded: the codes
are drawn with numpy in the reference's order, so they equal its codes
bit for bit, and handed over as uint8 tensors on the device the
simulator counts their histograms on.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.layer_graph import LayerGraph, LayerNode, conv, fc
from repro_torch.device import resolve_device


# ---------------------------------------------------------------- VGG-16
def vgg16() -> LayerGraph:
    cfg = [
        (3, 64, 224), (64, 64, 224),
        (64, 128, 112), (128, 128, 112),
        (128, 256, 56), (256, 256, 56), (256, 256, 56),
        (256, 512, 28), (512, 512, 28), (512, 512, 28),
        (512, 512, 14), (512, 512, 14), (512, 512, 14),
    ]
    layers = [
        conv(f"conv{i+1}", cin, cout, 3, hw) for i, (cin, cout, hw) in enumerate(cfg)
    ]
    layers += [
        fc("fc6", 512 * 7 * 7, 4096),
        fc("fc7", 4096, 4096),
        fc("fc8", 4096, 1000),
    ]
    return LayerGraph("VGG-16", layers)


# ---------------------------------------------------------------- ResNet-50
def resnet50() -> LayerGraph:
    layers: List[LayerNode] = [conv("conv1", 3, 64, 7, 112, stride=2, ih=224, iw=224)]
    stage_cfg = [  # (blocks, mid_channels, out_channels, spatial)
        (3, 64, 256, 56),
        (4, 128, 512, 28),
        (6, 256, 1024, 14),
        (3, 512, 2048, 7),
    ]
    cin = 64
    for si, (blocks, mid, cout, hw) in enumerate(stage_cfg):
        for b in range(blocks):
            p = f"s{si+2}b{b+1}"
            layers.append(conv(f"{p}.c1", cin, mid, 1, hw))
            layers.append(conv(f"{p}.c2", mid, mid, 3, hw))
            layers.append(conv(f"{p}.c3", mid, cout, 1, hw))
            if b == 0:  # projection shortcut
                layers.append(conv(f"{p}.proj", cin, cout, 1, hw))
            cin = cout
    layers.append(fc("fc", 2048, 1000))
    return LayerGraph("ResNet-50", layers)


# ---------------------------------------------------------------- DenseNet-161
def densenet161() -> LayerGraph:
    growth, init = 48, 96
    block_cfg = [(6, 56), (12, 28), (36, 14), (24, 7)]
    layers: List[LayerNode] = [conv("conv0", 3, init, 7, 112, stride=2, ih=224, iw=224)]
    ch = init
    for bi, (reps, hw) in enumerate(block_cfg):
        for r in range(reps):
            p = f"d{bi+1}l{r+1}"
            layers.append(conv(f"{p}.b", ch, 4 * growth, 1, hw))      # bottleneck 1×1
            layers.append(conv(f"{p}.c", 4 * growth, growth, 3, hw))  # 3×3
            ch += growth
        if bi < len(block_cfg) - 1:  # transition: 1×1 halving + pool
            layers.append(conv(f"t{bi+1}", ch, ch // 2, 1, hw))
            ch //= 2
    layers.append(fc("fc", ch, 1000))
    return LayerGraph("DenseNet-161", layers)


# ---------------------------------------------------------------- BERT
def _bert(name: str, n_layers: int, d: int, ff: int, seq: int = 128) -> LayerGraph:
    layers: List[LayerNode] = []
    for i in range(n_layers):
        p = f"L{i}"
        for proj in ("q", "k", "v", "o"):
            layers.append(fc(f"{p}.{proj}", d, d, tokens=seq))
        layers.append(fc(f"{p}.ff1", d, ff, tokens=seq))
        layers.append(fc(f"{p}.ff2", ff, d, tokens=seq))
    layers.append(fc("pooler", d, d, tokens=1))
    return LayerGraph(name, layers)


def bert_base() -> LayerGraph:
    return _bert("BERT-Base", 12, 768, 3072)


def bert_large() -> LayerGraph:
    return _bert("BERT-Large", 24, 1024, 4096)


PAPER_NETS: Dict[str, Callable[[], LayerGraph]] = {
    "vgg16": vgg16,
    "resnet50": resnet50,
    "densenet161": densenet161,
    "bert_base": bert_base,
    "bert_large": bert_large,
}


def build_net(name: str) -> LayerGraph:
    return PAPER_NETS[name]()


def synth_layer_codes(
    graph: LayerGraph,
    seed: int = 0,
    max_samples: int = 1_000_000,
    mean_jitter: float = 0.8,
    outlier_frac: float = 0.005,
    outlier_scale: float = 6.0,
    device="cuda",
) -> List[Tuple[str, torch.Tensor]]:
    """Seeded synthetic INT8 weight codes per layer (see module docstring),
    each layer's a uint8 tensor on ``device``.

    The simulator consumes code *distributions*; sampling is capped at
    ``max_samples`` per layer, which leaves the per-cell histograms
    statistically indistinguishable from the full tensor.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out: List[Tuple[str, torch.Tensor]] = []
    for layer in graph.layers:
        n = min(layer.weights, max_samples)
        sigma = float(np.sqrt(2.0 / layer.kernel_volume))
        mu = float(rng.uniform(-mean_jitter, mean_jitter)) * sigma
        w = rng.normal(mu, sigma, size=n)
        n_out = int(n * outlier_frac)
        if n_out:
            idx = rng.choice(n, size=n_out, replace=False)
            w[idx] = rng.normal(mu, outlier_scale * sigma, size=n_out)
        lo, hi = w.min(), w.max()
        scale = max(hi - lo, 1e-8) / 255.0
        codes = np.clip(np.round((w - lo) / scale), 0, 255).astype(np.uint8)
        out.append((layer.name, torch.from_numpy(codes).to(dev)))
    return out
