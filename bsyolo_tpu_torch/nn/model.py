"""Graph-walking detection model (counterpart of ``bsyolo_tpu/nn/model.py``).

``DetectionGraph`` runs a parsed ``ModelSpec`` layer by layer, keeping the
outputs the save-list names for later layers. Its layers live in
``self.model``, an ``nn.ModuleList``, so parameter keys read
``model.{i}.…`` like the reference torch graph.
"""

from __future__ import annotations

import copy
import itertools
from typing import Dict, List, Sequence

import torch
import torch.nn as nn

from bsyolo_tpu_torch.nn import modules as M
from bsyolo_tpu_torch.nn.heads import OBB, Classify, Detect, Pose, Segment
from bsyolo_tpu_torch.nn.parser import LayerSpec, ModelSpec


def _build_layer(spec: LayerSpec, strides, dropout: float = 0.0) -> nn.Module:
    m, a, c1 = spec.module, spec.args, spec.c1

    def opt(i, default):
        return a[i] if len(a) > i else default

    if m == "Conv":
        return M.Conv(c1, a[0], opt(1, 1), opt(2, 1), opt(3, None), opt(4, 1), opt(5, 1), opt(6, True))
    if m == "DWConv":
        return M.DWConv(c1, a[0], opt(1, 1), opt(2, 1), opt(3, 1), opt(4, True))
    if m in ("C3k2", "C3k2_gai"):
        cls = M.C3k2 if m == "C3k2" else M.C3k2_gai
        return cls(c1, a[0], a[1], c3k=opt(2, False), e=opt(3, 0.5), g=opt(4, 1), shortcut=opt(5, True))
    if m == "C2f":
        return M.C2f(c1, a[0], a[1], opt(2, False), opt(3, 1))
    if m == "C3":
        return M.C3(c1, a[0], a[1], opt(2, True))
    if m == "Bottleneck":
        return M.Bottleneck(c1, a[0], opt(1, True))
    if m == "SPPF":
        return M.SPPF(c1, a[0], opt(1, 5))
    if m == "C2PSA":
        return M.C2PSA(c1, a[0], a[1], opt(2, 0.5))
    if m == "SCDown":
        return M.SCDown(c1, a[0], a[1], a[2])
    if m == "MSCAAttention":
        return M.MSCAAttention(a[0])
    if m == "ELA":
        return M.ELA(a[0])
    if m == "Upsample":
        return nn.Upsample(scale_factor=opt(1, 2), mode=opt(2, "nearest"))
    if m == "Concat":
        return M.Concat(opt(0, 1))
    if m == "Detect":
        return Detect(a[0], a[1], strides)
    if m == "Segment":
        return Segment(a[0], a[1], a[2], a[3], strides)
    if m == "Pose":
        return Pose(a[0], a[1], a[2], strides)
    if m == "OBB":
        return OBB(a[0], a[1], a[2], strides)
    if m == "Classify":
        return Classify(c1, a[0], dropout)
    raise NotImplementedError(f"module {m} has no layer constructor in DetectionGraph")


class DetectionGraph(nn.Module):
    """Executes a ModelSpec; the output is the head's: a list of raw per-level maps (Detect,
    Pose, OBB), ``{"feats": levels, "proto": prototypes}`` (Segment), or (B, nc) class logits
    (Classify)."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        layers = []
        for layer in spec.layers:
            if layer.n > 1:  # plain repeated modules become a Sequential, children 0..n-1
                layers.append(nn.Sequential(*(_build_layer(layer, spec.head_strides) for _ in range(layer.n))))
            else:
                layers.append(_build_layer(layer, spec.head_strides, spec.dropout))
        self.model = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, embed: Sequence[int] = ()):
        """The head's list of per-level maps; with ``embed`` (layer indices), the global-average-pooled
        outputs of those layers concatenated over channels, (B, C1 + C2 + ...), the walk stopping at the
        last of them (``bsyolo_tpu/nn/model.py`` embed)."""
        saved: Dict[int, torch.Tensor] = {}
        save = set(self.spec.save)
        pooled: List[torch.Tensor] = []
        last = max(embed) if embed else -1
        for layer, m in zip(self.spec.layers, self.model):
            if len(layer.f) > 1:
                x = m([x if j == -1 else saved[j] for j in layer.f])
            else:
                x = m(x if layer.f[0] == -1 else saved[layer.f[0]])
            if layer.i in save:
                saved[layer.i] = x
            if layer.i in embed:
                pooled.append(x.mean((2, 3)) if x.ndim == 4 else x.reshape(x.shape[0], -1))
                if layer.i == last:
                    return torch.cat(pooled, 1)
        return x


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def build_model(spec: ModelSpec, device, seed: int = 0, dtype: torch.dtype = torch.float32) -> DetectionGraph:
    """Build the graph with weights drawn from a seeded ``torch.Generator`` on the
    host, then move it to ``device`` in eval mode: the same seed gives the same
    weights on every device. ``dtype`` is the compute dtype (``set_compute_dtype``);
    the parameters are float32 either way."""
    model = DetectionGraph(spec)
    g = torch.Generator().manual_seed(seed)
    M.reset_parameters(model, g)
    if isinstance(model.model[-1], Detect):
        model.model[-1].bias_init()
    set_compute_dtype(model, dtype)
    return model.to(device).eval()


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Run every convolution and linear layer of ``model`` in ``dtype``, float32 or bfloat16: the JAX
    package's ``DetectionGraph(dtype=...)``, whatever the head. Parameters, gradients and BatchNorm
    statistics stay float32; the head's levels, Segment's prototypes and Classify's logits come out in
    ``dtype``. Returns ``model``."""
    if dtype not in COMPUTE_DTYPES:
        raise TypeError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    for m in M.cast_convs(model):
        m.compute_dtype = None if dtype == torch.float32 else dtype  # float32: the weights' own dtype, no cast
    return model


def compute_dtype(model: nn.Module) -> torch.dtype:
    """The compute dtype of ``model``'s convolutions."""
    conv = M.cast_convs(model)[0]
    return conv.compute_dtype or conv.weight.dtype


def cast_inference_graph(model: nn.Module, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """An inference copy of ``model`` computing in ``dtype`` with the weights and biases of its
    convolutions, Proto's transposed convolution and Classify's linear layer stored in ``dtype``
    once (the counterpart of the JAX package's ``cast_inference_params``, which casts every float32
    weight of rank 2 or more: weights cast once, not per call). Every other tensor is
    shared with ``model``: BatchNorm's statistics and affine parameters and ELA's fusion
    weights stay float32, so the copy sees later updates of them; a change of the
    convolution weights needs a new copy. The int8 mode and its scales are copied; hooks
    registered on ``model`` are not."""
    shared = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    graph = copy.deepcopy(model, shared)
    for m in M.cast_convs(graph):
        m.weight = nn.Parameter(m.weight.detach().to(dtype), requires_grad=False)
        if m.bias is not None:
            m.bias = nn.Parameter(m.bias.detach().to(dtype), requires_grad=False)
    for m in graph.modules():
        m._forward_hooks.clear()
        m._forward_pre_hooks.clear()
        if isinstance(m, M.Conv):
            m._int8_cache = None
            m._calib_hook = None
    return set_compute_dtype(graph, dtype).eval()


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
