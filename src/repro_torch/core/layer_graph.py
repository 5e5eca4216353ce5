"""Layer-graph IR consumed by the ARAS scheduler and the simulators — a
copy of `repro.core.layer_graph` (pure Python) for the port.

The paper's offline flow (Fig 6) extracts a Data-Flow Graph from the PyTorch
model; here the equivalent is a linearized (topologically ordered) list of
weighted layers plus their activation footprints.  Only weight-bearing layers
(CONV / FC / projections) occupy crossbars; SFU ops (pooling, activations,
norms) ride along and are folded into the producing layer's output.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

from repro_torch.xbar.mapping import CrossbarSpec, LayerMapping, map_layer


@dataclasses.dataclass(frozen=True)
class LayerNode:
    """One weight-bearing layer.

    kernel_volume : weights per output unit (R*S*C for CONV, C_in for FC)
    num_kernels   : output units with distinct weight columns (K / C_out)
    windows       : activation windows streamed per inference
                    (OH*OW for CONV, #tokens for transformer FC, 1 for MLP head)
    """

    name: str
    kind: str                 # 'conv' | 'fc'
    kernel_volume: int
    num_kernels: int
    windows: int
    in_act_bytes: int
    out_act_bytes: int

    @property
    def weights(self) -> int:
        return self.kernel_volume * self.num_kernels

    @property
    def weight_bytes(self) -> int:
        return self.weights  # INT8: 1 byte per weight

    @property
    def macs(self) -> int:
        return self.weights * self.windows

    def mapping(self, spec: CrossbarSpec = CrossbarSpec()) -> LayerMapping:
        return map_layer(self.kernel_volume, self.num_kernels, self.windows, spec)


@dataclasses.dataclass(frozen=True)
class LayerGraph:
    name: str
    layers: List[LayerNode]

    @property
    def total_weights(self) -> int:
        return sum(l.weights for l in self.layers)

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def max_act_bytes(self) -> int:
        return max(l.in_act_bytes + l.out_act_bytes for l in self.layers)

    def __iter__(self) -> Iterable[LayerNode]:
        return iter(self.layers)

    def __len__(self) -> int:
        return len(self.layers)


def conv(
    name: str,
    cin: int,
    cout: int,
    k: int,
    oh: int,
    ow: Optional[int] = None,
    act_bytes: int = 1,
    stride: int = 1,
    ih: Optional[int] = None,
    iw: Optional[int] = None,
) -> LayerNode:
    """Helper for square CONV layers (INT8 activations by default)."""
    ow = ow if ow is not None else oh
    ih = ih if ih is not None else oh * stride
    iw = iw if iw is not None else ow * stride
    return LayerNode(
        name=name,
        kind="conv",
        kernel_volume=cin * k * k,
        num_kernels=cout,
        windows=oh * ow,
        in_act_bytes=cin * ih * iw * act_bytes,
        out_act_bytes=cout * oh * ow * act_bytes,
    )


def fc(name: str, cin: int, cout: int, tokens: int = 1, act_bytes: int = 1) -> LayerNode:
    return LayerNode(
        name=name,
        kind="fc",
        kernel_volume=cin,
        num_kernels=cout,
        windows=tokens,
        in_act_bytes=cin * tokens * act_bytes,
        out_act_bytes=cout * tokens * act_bytes,
    )
